"""Planned dense executor: host-planned layouts, pure-dataflow level programs.

Third executor next to core/tree.py (host-driven) and core/device_tree.py
(device-resident block lists). Same scheduler semantics as both
(lmj_PF3D_Divide_ConquerStereo/Mono, /root/reference/linux/src/LinearSFMImp/
LinearSFMImp.cpp:1926-2099, :6511-6658), but:

* All id/slot bookkeeping — feature matching (:2575-2599), pose
  identification (:7383-7409), re-gauge decisions (:1997), compaction — is
  precomputed on the host by core/layout.py. The tree schedule is a pure
  function of the input ids, so none of it belongs on the device.
* Maps travel as dense block tensors (ops/dense.DenseMap); level programs
  contain only gathers with host indices, einsums, and Cholesky solves — no
  sort, scatter, argmax, or searchsorted anywhere: the combinatorics ride
  the control plane, the device sees pure dataflow.

Memory is O(M^2 + M N) blocks per map instead of O(nnz); at the bundled
dataset scales this is far below device memory and buys back orders of magnitude in
op-dispatch efficiency. For root joins beyond ~2-3k poses, use the
block-list executor (device_tree) or the sharded Schur path.

STATUS: an experiment. This executor's fused level programs are
several-fold larger than device_tree's to compile, and it has not beaten
device_tree; it has not been measured on the H100. The production path is
core/device_tree.py (also the bench.py default); this file is kept for the
layout/planning machinery.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import jax
import jax.numpy as jnp
import numpy as np

from .. import types
from ..ops import dense as D
from ..ops.rotations import wrap_angle_pi, wrap_angle_diff
from . import compact as compact_mod
from . import layout as L

log = logging.getLogger("linearsfm_tpu")


# ---------------------------------------------------------------------------
# gathers (src < 0 -> zero)
# ---------------------------------------------------------------------------

def _gv(x, src):
    ok = src >= 0
    t = x[jnp.clip(src, 0, x.shape[0] - 1)]
    return jnp.where(ok.reshape((-1,) + (1,) * (t.ndim - 1)), t, 0.0)


def _g2(A, src):
    t = _gv(A, src)                    # [Mo, 6, Mi, 6]
    t = jnp.swapaxes(t, 0, 2)          # [Mi, 6, Mo, 6]
    t = _gv(t, src)                    # [Mo, 6, Mo, 6] (cols gathered)
    return jnp.swapaxes(t, 0, 2)


def _gw(Wd, srcP, srcF):
    t = _gv(Wd, srcP)                  # [Mo, Ni, 6, 3]
    t = jnp.swapaxes(t, 0, 1)          # [Ni, Mo, 6, 3]
    t = _gv(t, srcF)                   # [No, Mo, 6, 3]
    return jnp.swapaxes(t, 0, 1)


def _zero_pose(A, Wd, slot):
    A = A.at[slot].set(0.0)
    A = A.at[:, :, slot, :].set(0.0)
    return A, Wd.at[slot].set(0.0)


def densify(lm: types.LocalMap, Mc: int, Nc: int):
    """Host: block lists -> dense (A, Wd, V) numpy arrays at caps (Mc, Nc)."""
    m, n = int(lm.n_poses), int(lm.n_feats)
    nU, nW = int(lm.n_U), int(lm.n_W)
    A = np.zeros((Mc, 6, Mc, 6))
    Wd = np.zeros((Mc, Nc, 6, 3))
    V = np.zeros((Nc, 3, 3))
    U = np.asarray(lm.U)[:nU]
    Uij = np.asarray(lm.Uij)[:nU]
    Wb = np.asarray(lm.W)[:nW]
    Wpf = np.asarray(lm.Wpf)[:nW]
    r6 = np.arange(6)
    i, j = Uij[:, 0], Uij[:, 1]
    ii = np.broadcast_to(i[:, None, None], (nU, 6, 6))
    jj = np.broadcast_to(j[:, None, None], (nU, 6, 6))
    aa = np.broadcast_to(r6[None, :, None], (nU, 6, 6))
    bb = np.broadcast_to(r6[None, None, :], (nU, 6, 6))
    np.add.at(A, (ii, aa, jj, bb), U)
    offd = (i != j)[:, None, None]
    np.add.at(A, (jj, bb, ii, aa), np.where(offd, U, 0.0))
    p, f = Wpf[:, 0], Wpf[:, 1]
    pp = np.broadcast_to(p[:, None, None], (nW, 6, 3))
    ff = np.broadcast_to(f[:, None, None], (nW, 6, 3))
    wa = np.broadcast_to(r6[None, :, None], (nW, 6, 3))
    wc = np.broadcast_to(np.arange(3)[None, None, :], (nW, 6, 3))
    np.add.at(Wd, (pp, ff, wa, wc), Wb)
    V[:n] = np.asarray(lm.V)[:n]
    return A, Wd, V


class DenseTreeSolver:
    """Hierarchical solver on the dense planned path.

    Matches TreeSolver/DeviceTreeSolver numerically (method="direct", f64) —
    see tests/test_dense_tree.py. method="refine" applies the same
    mixed-precision policy as DeviceTreeSolver: f32 info at tree levels whose
    fused system has <= mixed_max_m poses, f64 info + f32-factor refinement
    above.
    """

    def __init__(self, datatype: str, method: str = "refine",
                 refine_iters: int = 3, bucket: int = 16,
                 mixed_max_m: int = 32, progress: bool = False,
                 fuse: bool = True):
        assert datatype in ("stereo", "mono")
        self.datatype = datatype
        self.method = method
        self.refine_iters = refine_iters
        self.bucket = bucket
        self.mixed_max_m = mixed_max_m if method == "refine" else 0
        self.progress = progress
        # fuse: compile the SMALL-count tail of the tree (levels with
        # count <= 64, plus the final re-gauge) into one XLA program. A tree
        # level is pure dataflow with host-planned indices, so nothing
        # forces a per-level dispatch — fusing amortizes the per-program
        # launch overhead exactly where compute is trivial. The wide early
        # levels stay one program each: fusing those (or the whole tree)
        # made the compiler run out of memory.
        self.fuse = fuse
        self.fuse_max_count = 64
        self._progs: dict = {}
        self.join_count = 0

    def _policy(self, joined_m: int):
        if joined_m <= self.mixed_max_m:
            return "float32", "direct"
        return ("float64", self.method) if self.method == "refine" else \
            ("float64", "direct")

    # -- one pairwise join lane ----------------------------------------------
    def _join_lane(self, g: D.DenseMap, m: D.DenseMap, slots, gsrcP, msrcP,
                   gsrcF, msrcF, idt, method):
        if self.datatype == "stereo":
            gt = D.transform_dense_stereo(g, slots[0], info_dtype=idt)
            mA, mW, mV = m.A.astype(idt), m.Wd.astype(idt), m.V.astype(idt)
            m_poses = m.poses
            gA, gW = gt.A, gt.Wd
            fixc = sign = None
        else:
            rs, ss, p1, p2, ofix, nfix, cref, cscap = [slots[k]
                                                       for k in range(8)]
            gt = D.transform_dense_mono(g, rs, ss, p1, p2, ofix, nfix,
                                        info_dtype=idt)
            # angle wraparound on the scale-pose blocks (:7427-7465)
            g_poses = gt.poses.at[p2, 3:6].set(wrap_angle_pi(gt.poses[p2, 3:6]))
            gt = gt._replace(poses=g_poses)
            m_ang = wrap_angle_diff(wrap_angle_pi(m.poses[cscap, 3:6]),
                                    g_poses[p2, 3:6])
            m_poses = m.poses.at[cscap, 3:6].set(m_ang)
            # zero-information joint-reference blocks dropped (:7482, :7619)
            gA, gW = _zero_pose(gt.A, gt.Wd, p1)
            mA, mW = _zero_pose(m.A.astype(idt), m.Wd.astype(idt), cref)
            mV = m.V.astype(idt)
            fixc = 6 * p2 + nfix
            sign = gt.sign.astype(idt)

        gt2 = gt._replace(A=gA, Wd=gW)
        ePg, eFg = D.info_vector_dense(gt2, idt)
        m2 = D.DenseMap(m_poses, m.feats, mA, mW, mV, m.sign)
        ePm, eFm = D.info_vector_dense(m2, idt)

        A = _g2(gA, gsrcP) + _g2(mA, msrcP)
        Wd = _gw(gW, gsrcP, gsrcF) + _gw(mW, msrcP, msrcF)
        V = _gv(gt.V, gsrcF) + _gv(mV, msrcF)
        eP = _gv(ePg, gsrcP) + _gv(ePm, msrcP)
        eF = _gv(eFg, gsrcF) + _gv(eFm, msrcF)

        Mo = gsrcP.shape[0]
        valid = (gsrcP >= 0) | (msrcP >= 0)
        fixed = ~jnp.repeat(valid, 6)
        if self.datatype == "mono":
            coord = jnp.arange(6 * Mo)
            p1 = slots[2]
            fixed |= (coord >= 6 * p1) & (coord < 6 * p1 + 6)
            fixed |= coord == fixc
        xp, xf = D.solve_dense(A, Wd, V, eP, eF, fixed, method=method,
                               refine_iters=self.refine_iters,
                               fixc=fixc, sign=sign)
        sdt = g.poses.dtype
        return D.DenseMap(xp.astype(sdt), xf.astype(sdt), A, Wd, V,
                          m.sign.astype(sdt))

    def _regauge_lane(self, dm: D.DenseMap, slots, idt):
        if self.datatype == "stereo":
            return D.transform_dense_stereo(dm, slots[0], info_dtype=idt)
        return D.transform_dense_mono(dm, slots[0], slots[1], slots[2],
                                      slots[3], slots[4], slots[5],
                                      info_dtype=idt)

    # -- level body (pure dataflow; jitted per level or fused whole) ----------
    def _level_body(self, lp: L.DenseLevelPlan, x: D.DenseMap,
                    b: dict) -> D.DenseMap:
        # policy keyed on the pre-dedup joined width (= DeviceTreeSolver's
        # key) so both executors assign the same levels to f32
        idt, method = self._policy(2 * lp.caps_in[0])
        count = lp.count
        npair, nxt = count // 2, (count + 1) // 2
        Mo, No = lp.caps_out
        idx_rg = tuple(i for i in range(nxt) if lp.regauge[i])
        idx_nr = tuple(i for i in range(nxt) if not lp.regauge[i])
        perm = np.argsort(np.array(idx_nr + idx_rg, np.int32))

        def grow(dm: D.DenseMap) -> D.DenseMap:
            Mi, Ni = dm.M, dm.N
            poses = jnp.pad(dm.poses, ((0, Mo - Mi), (0, 0)))
            feats = jnp.pad(dm.feats, ((0, No - Ni), (0, 0)))
            A = jnp.pad(dm.A, ((0, Mo - Mi), (0, 0), (0, Mo - Mi), (0, 0)))
            Wd = jnp.pad(dm.Wd, ((0, Mo - Mi), (0, No - Ni), (0, 0), (0, 0)))
            V = jnp.pad(dm.V, ((0, No - Ni), (0, 0), (0, 0)))
            return D.DenseMap(poses, feats, A.astype(jnp.dtype(idt)),
                              Wd.astype(jnp.dtype(idt)),
                              V.astype(jnp.dtype(idt)), dm.sign)

        G = jax.tree.map(lambda a: a[0:2 * npair:2], x)
        Mb = jax.tree.map(lambda a: a[1:2 * npair:2], x)
        merged = jax.vmap(
            lambda g, m, s, a1, a2, a3, a4: self._join_lane(
                g, m, s, a1, a2, a3, a4, idt, method)
        )(G, Mb, b["slots"], b["gsrcP"], b["msrcP"], b["gsrcF"],
          b["msrcF"])
        if count % 2 == 1:
            carry = grow(jax.tree.map(lambda a: a[count - 1], x))
            merged = jax.tree.map(
                lambda a, c: jnp.concatenate([a, c[None]]), merged, carry)
        parts = []
        if idx_nr:
            parts.append(jax.tree.map(lambda a: a[np.array(idx_nr)], merged))
        if idx_rg:
            sub = jax.tree.map(lambda a: a[np.array(idx_rg)], merged)
            parts.append(jax.vmap(
                lambda dm, s: self._regauge_lane(dm, s, idt))(
                    sub, b["rg_slots"]))
        out = (parts[0] if len(parts) == 1
               else jax.tree.map(lambda a, c: jnp.concatenate([a, c]),
                                 *parts))
        return jax.tree.map(lambda a: a[perm], out)

    def _final_body(self, regauge: bool, x: D.DenseMap,
                    slots) -> D.DenseMap:
        root = jax.tree.map(lambda a: a[0], x)
        root = jax.tree.map(
            lambda a: a.astype(jnp.float64)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, root)
        if regauge:
            root = self._regauge_lane(root, slots, "float64")
        return root

    def _level_program(self, lp: L.DenseLevelPlan):
        idt, method = self._policy(2 * lp.caps_in[0])
        key = (lp.count, lp.caps_in, lp.caps_out, lp.regauge, idt, method)
        if key not in self._progs:
            self._progs[key] = jax.jit(
                lambda x, b, lp=lp: self._level_body(lp, x, b))
        return self._progs[key]

    def _final_program(self, caps, slots_or_none):
        key = ("final", caps, slots_or_none is not None)
        if key not in self._progs:
            self._progs[key] = jax.jit(
                lambda x, s, rg=slots_or_none is not None:
                self._final_body(rg, x, s))
        return self._progs[key]

    def _chunk_program(self, lps: tuple, final_rg):
        """One XLA program for a group of consecutive levels.

        final_rg: None = not the last chunk; else bool root_regauge (the
        final f64 cast + re-gauge is folded into the last chunk). Grouping
        bounds the per-program size — the compiler ran out of memory on a
        whole-512-map-tree single program — while still amortizing dispatch
        overhead ~chunk-fold.
        """
        key = ("chunk",
               tuple((lp.count, lp.caps_in, lp.caps_out, lp.regauge,
                      self._policy(2 * lp.caps_in[0])) for lp in lps),
               final_rg)
        if key in self._progs:
            return self._progs[key]

        def prog(x: D.DenseMap, bundles, root_slots):
            for lp, b in zip(lps, bundles):
                x = self._level_body(lp, x, b)
            if final_rg is not None:
                x = self._final_body(final_rg, x, root_slots)
            return x

        self._progs[key] = jax.jit(prog)
        return self._progs[key]

    # -- host prep: plan + batched densify (cached per maps-list identity) ----
    def _prepare(self, maps: list[types.LocalMap]):
        if getattr(self, "_prep_maps", None) is maps:
            return self._prep
        st = compact_mod.compact_stack(maps, self.bucket, 1)
        layouts = []
        pid_all = np.asarray(st.pose_ids)
        fid_all = np.asarray(st.feat_ids)
        g = st.gauge
        for b in range(pid_all.shape[0]):
            pid, fid = pid_all[b], fid_all[b]
            layouts.append(L.NodeLayout(
                pose_ids=pid[pid >= 0].astype(np.int32),
                feat_ids=fid[fid >= 0].astype(np.int32),
                ref=int(g.ref[b]), scap=int(g.scap[b]), fix=int(g.fix[b]),
                fref=int(g.fref[b]), fscap=int(g.fscap[b]),
                ffix=int(g.ffix[b])))
        plan = L.plan_dense_tree(layouts, self.datatype, self.bucket)
        if not plan.levels:
            self._prep = (plan, None, layouts)
            self._prep_maps = maps
            return self._prep

        # batched densify of the stacked lists (padding blocks are zero with
        # index (0,0), so scatter-adding them is harmless)
        Mi, Ni = plan.levels[0].caps_in
        B, Ms = pid_all.shape
        Ns = fid_all.shape[1]
        assert Ms <= Mi and Ns <= Ni, (Ms, Ns, plan.levels[0].caps_in)
        idt0, _ = self._policy(2 * Mi)
        ndt = np.dtype(idt0)
        A = np.zeros((B, Mi, 6, Mi, 6), ndt)
        Wd = np.zeros((B, Mi, Ni, 6, 3), ndt)
        V = np.zeros((B, Ni, 3, 3), ndt)
        poses = np.zeros((B, Mi, 6))
        feats = np.zeros((B, Ni, 3))
        poses[:, :Ms] = np.asarray(st.poses)
        feats[:, :Ns] = np.asarray(st.feats)
        V[:, :Ns] = np.asarray(st.V)
        U = np.asarray(st.U).astype(ndt)
        Uij = np.asarray(st.Uij)
        Wl = np.asarray(st.W).astype(ndt)
        Wpf = np.asarray(st.Wpf)
        KU, KW = U.shape[1], Wl.shape[1]
        r6, r3 = np.arange(6), np.arange(3)

        def grid(idx, d1, d2):
            return np.broadcast_to(idx[:, :, None, None],
                                   (B, idx.shape[1], d1, d2))
        bb = np.broadcast_to(np.arange(B)[:, None, None, None],
                             (B, KU, 6, 6))
        aa = np.broadcast_to(r6[None, None, :, None], (B, KU, 6, 6))
        cc = np.broadcast_to(r6[None, None, None, :], (B, KU, 6, 6))
        i, j = Uij[..., 0], Uij[..., 1]
        np.add.at(A, (bb, grid(i, 6, 6), aa, grid(j, 6, 6), cc), U)
        offd = (i != j)[:, :, None, None]
        np.add.at(A, (bb, grid(j, 6, 6), cc, grid(i, 6, 6), aa),
                  np.where(offd, U, 0.0))
        wb = np.broadcast_to(np.arange(B)[:, None, None, None],
                             (B, KW, 6, 3))
        wa = np.broadcast_to(r6[None, None, :, None], (B, KW, 6, 3))
        wc = np.broadcast_to(r3[None, None, None, :], (B, KW, 6, 3))
        np.add.at(Wd, (wb, grid(Wpf[..., 0], 6, 3), grid(Wpf[..., 1], 6, 3),
                       wa, wc), Wl)
        x = D.DenseMap(poses, feats, A, Wd, V,
                       np.asarray(g.sign, np.float64))
        self._prep = (plan, x, layouts)
        self._prep_maps = maps
        return self._prep

    # -- full tree -----------------------------------------------------------
    def run(self, maps: list[types.LocalMap], metrics=None) -> types.LocalMap:
        t0 = time.time()
        plan, x0, layouts = self._prepare(maps)
        t1 = time.time()
        if not plan.levels:
            return compact_mod.compact(jax.device_get(maps[0]), 1, 1)
        x = jax.device_put(x0)
        t2 = time.time()

        def bundle_of(lp):
            b = dict(lp.bundle)
            b["rg_slots"] = (lp.rg_bundle["slots"] if lp.rg_bundle is not None
                             else np.zeros((0, 1), np.int32))
            return b

        root_slots = np.asarray(plan.root_slots or (0,), np.int32)
        if self.fuse:
            lps = plan.levels
            ntail = sum(1 for lp in lps if lp.count <= self.fuse_max_count)
            nhead = len(lps) - ntail
            for li, lp in enumerate(lps[:nhead]):
                x = self._chunk_program((lp,), None)(
                    x, (bundle_of(lp),), root_slots)
                self.join_count += lp.count // 2
                if metrics is not None:
                    metrics.record(li + 1, (lp.count + 1) // 2, lp.count // 2,
                                   M=lp.caps_out[0], N=lp.caps_out[1],
                                   wall=round(time.time() - t0, 4))
            tail = lps[nhead:]
            y = self._chunk_program(tail, plan.root_regauge)(
                x, tuple(bundle_of(lp) for lp in tail), root_slots)
            self.join_count += sum(lp.count // 2 for lp in tail)
            if metrics is not None:
                # the fused tail is one program: record its levels as one
                # dispatch each, sharing the program's wall
                for ti, lp in enumerate(tail):
                    metrics.record(nhead + ti + 1, (lp.count + 1) // 2,
                                   lp.count // 2, M=lp.caps_out[0],
                                   N=lp.caps_out[1], fused=True,
                                   wall=round(time.time() - t0, 4))
        else:
            for li, lp in enumerate(plan.levels):
                x = self._level_program(lp)(x, bundle_of(lp))
                self.join_count += lp.count // 2
                if metrics is not None:
                    metrics.record(li + 1, (lp.count + 1) // 2, lp.count // 2,
                                   M=lp.caps_out[0], N=lp.caps_out[1],
                                   wall=round(time.time() - t0, 4))
                if self.progress:
                    log.info("Level %d dispatched (%d maps)", li + 1,
                             (lp.count + 1) // 2)
            y = self._final_program((x.M, x.N), plan.root_slots)(x, root_slots)
        t3 = time.time()
        poses, feats = jax.device_get((y.poses, y.feats))
        t4 = time.time()
        self._last_timing = dict(prep=round(t1 - t0, 4),
                                 upload=round(t2 - t1, 4),
                                 levels=round(t3 - t2, 4),
                                 get=round(t4 - t3, 4))
        self._last_dense = y
        root = plan.root
        M, N = poses.shape[0], feats.shape[0]
        pose_ids = np.full(M, -1, np.int32)
        pose_ids[:root.m] = root.pose_ids
        feat_ids = np.full(N, -1, np.int32)
        feat_ids[:root.n] = root.feat_ids
        gauge = types.Gauge(
            np.int32(root.ref), np.int32(root.scap), np.int32(root.fix),
            np.int32(1), np.int32(root.fref), np.int32(root.fscap),
            np.int32(root.ffix))
        # info lists intentionally empty: the dense info stays in
        # self._last_dense; writers/ATE/tests consume states only.
        z6 = np.zeros((1, 6, 6))
        return types.LocalMap(
            pose_ids=pose_ids, poses=poses, feat_ids=feat_ids, feats=feats,
            U=z6, Uij=np.zeros((1, 2), np.int32), W=np.zeros((1, 6, 3)),
            Wpf=np.zeros((1, 2), np.int32), V=np.zeros((N, 3, 3)),
            n_poses=np.int32(root.m), n_feats=np.int32(root.n),
            n_U=np.int32(0), n_W=np.int32(0), gauge=gauge)
