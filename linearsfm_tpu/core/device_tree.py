"""Device-resident merge tree: one XLA program per level, maps stay on device.

The host-driven scheduler (core/tree.py) round-trips every map through numpy
between levels and compacts each map on the host. Here the whole level —
all pairwise joins (vmapped), the every-2nd-map re-gauge
(/root/reference/linux/src/LinearSFMImp/LinearSFMImp.cpp:1997-2030), the odd
carry (:1946-1948), and map compaction — is ONE jitted program operating on a
stacked [count, ...caps] pytree. The host only:

* builds the static capacity plan up front (core/plan.py),
* dispatches one program per level,
* fetches the root map at the end.

Schur systems always use the dense-W assembly (no per-level max_obs
statistics exist on the host). method="refine" solves each join with an f32
Cholesky preconditioning f64 PCG (ops/schur.solve_full_mixed);
method="direct" with an f64 dense Cholesky (ops/solve.py).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np

from .. import types
from ..ops import congruence
from ..utils import checkpoint
from . import compact as compact_mod
from . import dcompact
from . import join as join_mod
from . import plan as plan_mod

log = logging.getLogger("linearsfm_tpu")

# Threads that compile a cold tree's level programs at once (ensure_warm).
COMPILE_WORKERS = 6


def pad_to_device(lm: types.LocalMap, M: int, N: int, KU: int,
                  KW: int) -> types.LocalMap:
    """Grow capacities on device (jnp analog of LocalMap.pad_to)."""
    def pad(x, k, fill=0):
        return jnp.pad(x, [(0, k - x.shape[0])] + [(0, 0)] * (x.ndim - 1),
                       constant_values=fill)
    return dataclasses.replace(
        lm,
        pose_ids=pad(lm.pose_ids, M, -1), poses=pad(lm.poses, M),
        feat_ids=pad(lm.feat_ids, N, -1), feats=pad(lm.feats, N),
        U=pad(lm.U, KU), Uij=pad(lm.Uij, KU),
        W=pad(lm.W, KW), Wpf=pad(lm.Wpf, KW),
        V=pad(lm.V, N),
    )


class DeviceTreeSolver:
    """Device-resident hierarchical solver (same semantics as TreeSolver).

    Mirrors lmj_PF3D_Divide_ConquerStereo/Mono
    (LinearSFMImp.cpp:1926-2099, :6511-6658): binary-tree reduction with odd
    carry, every-2nd-map re-gauge, final re-gauge to the first map's frame.
    """

    def __init__(self, datatype: str, method: str = "refine",
                 refine_iters: int = 3, bucket: int = 16, u_bucket: int = 64,
                 pin: str = "sign", progress: bool = False,
                 mixed_max_m: int = 0, direct_min_m: int = 0,
                 top_min_m: int = 256, top_iters: int = 16,
                 plan_offset: int = 0, final_regauge: bool = True,
                 mesh=None, root_shard_min: int = 256,
                 escalate_tol: float = 1e-8, pcg_exit_tol: float = 1e-14):
        assert datatype in ("stereo", "mono")
        self.datatype = datatype
        # Multi-chip execution (None = single chip). A single-axis
        # jax.sharding.Mesh; each tree level picks its own parallel axis:
        #   "dp"  — any level with >= ndev pairs whose re-gauge flags are
        #           periodic in the device-local lane count (the every-2nd-
        #           output pattern always is): pair lanes are PADDED to a
        #           multiple of ndev with clones (dropped after) and the odd
        #           carry handled outside, then the level program runs under
        #           shard_map over the PAIR axis (the level's joins are
        #           independent, reference LinearSFMImp.cpp:1938-1993);
        #   "tp"  — the root-style count==2 levels with join_m >=
        #           root_shard_min: the single pair's solve shards the
        #           FEATURE axis (parallel/shard_solve.sharded_full_mixed,
        #           psum across devices) while transform/compact replicate;
        #   "rep" — in-between shapes (odd counts, few lanes) compile as the
        #           plain program; GSPMD places them freely.
        self.mesh = mesh
        self._axis = mesh.axis_names[0] if mesh is not None else None
        self._nd = int(mesh.devices.size) if mesh is not None else 0
        self.root_shard_min = root_shard_min
        self.escalate_tol = escalate_tol
        # Top-band PCG early exit: the 16-sweep cap exists for conditioning
        # safety, but measured residuals hit 1e-15..1e-23 well before it
        # (BENCH r5) — exiting at a near-machine relative residual halves
        # the dominant root-level wall with no accuracy change at printed
        # precision. 0 disables (fixed trip count).
        self.pcg_exit_tol = pcg_exit_tol
        # Subtree execution (multi-host host-local phase): global map offset
        # for the position-parity re-gauge policy + whether the tree root is
        # the WHOLE problem's root (parallel/multihost.py).
        self.plan_offset = plan_offset
        self.final_regauge = final_regauge
        self.method = method
        self.refine_iters = refine_iters
        self.pin = pin
        self.bucket = bucket
        self.u_bucket = u_bucket
        self.progress = progress
        # Mixed-precision policy (method="refine" only): the INFORMATION path
        # (congruence, info vectors, PCG matvecs) is always f64 — computed as
        # broadcast-multiply-sums, off dot_general (ops/smallmat); every
        # MATMUL-shaped op (dense Schur assembly, Cholesky, triangular
        # solves) runs in f32 as the PCG preconditioner
        # (ops/schur.solve_full_mixed). Iteration bands:
        #   joined_m < top_min_m : `refine_iters` PCG sweeps;
        #   joined_m >= top_min_m: `top_iters` sweeps — cond(S) grows with
        #       trajectory length and the preconditioner quality floor is
        #       cond*eps_f32, so the few top-level lanes pay more cheap
        #       elementwise iterations.
        # mixed_max_m > 0 would run levels below that size with f32
        # INFORMATION too — measured at 1024 maps to poison the whole tree
        # (ATE 68 vs oracle 1.06): low-level info error is amplified by
        # cond(I) of everything above. Off by default; the f32 info band is
        # only safe for short subsequences.
        # direct_min_m (default off) switches levels >= that size to a plain
        # f64 dense factorization. The mixed design was chosen for a machine
        # whose f64 matmuls ran at ~f32; on the H100 f64 is native, so
        # whether the f32 band still pays is an open measurement.
        self.mixed_max_m = mixed_max_m if method == "refine" else 0
        self.direct_min_m = direct_min_m if method == "refine" else 0
        self.top_min_m = top_min_m
        self.top_iters = top_iters
        self._progs: dict = {}
        self._aot: dict = {}   # same keys as _progs -> AOT-compiled executable
        self.join_count = 0

    def _cfg(self, joined_m: int) -> join_mod.JoinConfig:
        if joined_m <= self.mixed_max_m:
            return join_mod.JoinConfig(
                max_obs=1, method="direct", pin=self.pin, dense_schur=True,
                info_dtype="float32", with_res=True)
        if self.direct_min_m and joined_m >= self.direct_min_m:
            return join_mod.JoinConfig(
                max_obs=1, method="direct", pin=self.pin, dense_schur=True,
                info_dtype="float64", with_res=True)
        top = joined_m >= self.top_min_m
        iters = self.top_iters if top else self.refine_iters
        # Convergence control (top band only — the short-trajectory levels
        # converge in `refine_iters` by construction): if the PCG residual
        # still exceeds escalate_tol, run top_iters more sweeps (lax.cond;
        # the healthy path pays nothing). Residuals surface per level via
        # metrics (run()).
        return join_mod.JoinConfig(
            max_obs=1, method=self.method, refine_iters=iters,
            pin=self.pin, dense_schur=True, info_dtype="float64",
            with_res=True,
            escalate_iters=self.top_iters if top else 0,
            escalate_tol=self.escalate_tol,
            exit_tol=self.pcg_exit_tol if top else 0.0)

    # -- building blocks -----------------------------------------------------
    def _merge_one(self, g: types.LocalMap, m: types.LocalMap,
                   cfg: join_mod.JoinConfig) -> types.LocalMap:
        if self.datatype == "stereo":
            end = congruence.transform_map_stereo(g, m.gauge.ref,
                                                  info_dtype=cfg.info_dtype)
            return join_mod.join_stereo(end, m, cfg)
        end = congruence.transform_map_mono(g, m.gauge.ref, m.gauge.scap,
                                            m.gauge.fix,
                                            info_dtype=cfg.info_dtype)
        return join_mod.join_mono(end, m, cfg)

    def _regauge_compact(self, lm: types.LocalMap, caps_out, info_dtype):
        """Unconditional re-gauge to the final frame + compact to caps_out.

        Run ONLY on the statically-known re-gauging lanes (plan.LevelPlan
        .regauge): the id comparison ref > fref (LinearSFMImp.cpp:1997) is
        decided on the host by the exact plan, so the other lanes never pay
        for the transform."""
        g = lm.gauge
        if self.datatype == "stereo":
            t = congruence.transform_map_stereo(lm, g.fref,
                                                info_dtype=info_dtype)
        else:
            t = congruence.transform_map_mono(lm, g.fref, g.fscap, g.ffix,
                                              info_dtype=info_dtype)
        return dcompact.compact_device(t, *caps_out)[0]

    # -- level program ---------------------------------------------------------
    def _level_key(self, lp: plan_mod.LevelPlan):
        # Exact plans carry the true max joined pose count of the level; the
        # bucketed 2*caps_in[0] upper bound is only the count-based fallback
        # (it can straddle top_min_m and pick the wrong iteration band).
        cfg = self._cfg(lp.join_m if lp.join_m is not None
                        else 2 * lp.caps_in[0])
        return (lp.count, lp.caps_in, lp.caps_out, lp.regauge, cfg), cfg

    def _plan_modes(self, tp: plan_mod.TreePlan) -> list[str]:
        return [self._level_mode(lp, self._level_key(lp)[1])
                for lp in tp.levels]

    def _build_body(self, count: int, caps_out, flags, cfg):
        """Level program body over `count` stacked lanes.

        flags: re-gauge booleans for the (count+1)//2 output lanes. Also
        serves as the per-device body under shard_map ("dp" levels), where
        `count` is the device-local lane count and `flags` the (device-
        uniform) local pattern.
        """
        npair, nxt = count // 2, (count + 1) // 2
        idt = cfg.info_dtype
        idx_rg = tuple(i for i in range(nxt) if flags[i])
        idx_nr = tuple(i for i in range(nxt) if not flags[i])
        perm = np.argsort(np.array(idx_nr + idx_rg, np.int32))

        def prog(x: types.LocalMap):  # noqa: ANN001
            G = jax.tree.map(lambda a: a[0:2 * npair:2], x)
            Mb = jax.tree.map(lambda a: a[1:2 * npair:2], x)
            merged, res = jax.vmap(
                lambda g, m: self._merge_one(g, m, cfg))(G, Mb)
            if count % 2 == 1:
                carry = jax.tree.map(lambda a: a[count - 1], x)
                mg = jax.tree.map(lambda a: a[0], merged)
                carry = pad_to_device(carry, mg.M, mg.N, mg.KU, mg.KW)
                carry = jax.tree.map(
                    lambda c, m: c.astype(m.dtype) if hasattr(m, "dtype")
                    else c, carry, mg)
                merged = jax.tree.map(
                    lambda a, b: jnp.concatenate([a, b[None]]), merged, carry)
                res = jnp.concatenate([res, jnp.zeros((1,), res.dtype)])

            parts = []
            if idx_nr:
                sub = jax.tree.map(lambda a: a[np.array(idx_nr)], merged)
                parts.append(jax.vmap(
                    lambda lm: dcompact.compact_device(lm, *caps_out)[0])(sub))
            if idx_rg:
                sub = jax.tree.map(lambda a: a[np.array(idx_rg)], merged)
                parts.append(jax.vmap(
                    lambda lm: self._regauge_compact(lm, caps_out, idt))(sub))
            out = (parts[0] if len(parts) == 1
                   else jax.tree.map(lambda a, b: jnp.concatenate([a, b]),
                                     *parts))
            # res stays in MERGED order (pair i at slot i, carry last) —
            # diagnostics only, never re-enters the tree.
            return jax.tree.map(lambda a: a[perm], out), res

        return prog

    def _dp_pattern(self, lp: plan_mod.LevelPlan):
        """Device-uniform per-device regauge flag pattern for dp lane
        sharding, or None if this level can't shard.

        Arbitrary level counts — including the reference's odd-carry NC3500
        ladder 3499→1750→875→… (README.txt:64), where no level count is
        divisible by 2*ndev — are made shardable by PADDING the pair lanes to
        a multiple of ndev with clones of pair 0 (outputs dropped; the joins
        are lane-independent, LinearSFMImp.cpp:1938-1993) and carrying the
        odd lane outside the shard_map. The only remaining requirement is
        that the real pairs' regauge flags are periodic in the device-local
        lane count; the every-2nd-output pattern satisfies this whenever the
        local count is even, so both ceil(npair/ndev) and its even round-up
        are tried."""
        if self.mesh is None or self._nd <= 1 or lp.regauge is None:
            return None
        nd = self._nd
        npair = lp.count // 2
        if npair < nd:
            return None
        flags = tuple(bool(f) for f in lp.regauge[:npair])
        base = -(-npair // nd)
        for local in (base, base + (base & 1)):
            cand = (flags * ((local + npair - 1) // npair))[:local]
            if all(flags[i] == cand[i % local] for i in range(npair)):
                return cand
        return None

    def _level_mode(self, lp: plan_mod.LevelPlan, cfg) -> str:
        """Parallel axis for this level: dp | tp | rep | single (see ctor)."""
        if self.mesh is None or self._nd <= 1:
            return "single"
        if self._dp_pattern(lp) is not None:
            return "dp"
        if (lp.count == 2 and lp.regauge is not None
                and (lp.join_m or 0) >= self.root_shard_min
                and cfg.method == "refine"):
            return "tp"
        return "rep"

    def _level_program(self, lp: plan_mod.LevelPlan):
        key, cfg = self._level_key(lp)
        if key in self._progs:
            return self._progs[key]
        from jax.sharding import NamedSharding, PartitionSpec as P
        mode = self._level_mode(lp, cfg)
        if self.mesh is None:
            body = self._build_body(lp.count, lp.caps_out, lp.regauge, cfg)
            # Donate the level input: x is consumed (run() rebinds it), and
            # retiring the stacked buffer inside the program frees device
            # memory for the level's dense Schur systems.
            self._progs[key] = jax.jit(body, donate_argnums=0)
            return self._progs[key]

        # Every program takes REPLICATED inputs and emits REPLICATED outputs:
        # level counts are arbitrary (odd carries everywhere on the reference
        # datasets), and pjit in/out shardings require lane counts divisible
        # by the mesh — so dp levels slice their device's chunk from the
        # replicated stack inside shard_map (free) and pay one small
        # all-gather on the way out instead of chaining sharded boundaries.
        rep = NamedSharding(self.mesh, P())
        in_sh = rep
        if mode == "dp":
            nd = self._nd
            npair = lp.count // 2
            cand = self._dp_pattern(lp)
            local = len(cand)
            npair_pad = local * nd
            pad = npair_pad - npair
            odd = lp.count % 2 == 1
            carry_rg = bool(lp.regauge[npair]) if odd else False
            caps_out = lp.caps_out
            idt = cfg.info_dtype
            body = self._build_body(2 * local, caps_out, cand, cfg)
            sm = jax.shard_map(body, mesh=self.mesh,
                               in_specs=P(self._axis),
                               out_specs=(P(self._axis), P(self._axis)),
                               check_vma=False)

            def prog(x: types.LocalMap):  # noqa: ANN001
                xp = jax.tree.map(lambda a: a[:2 * npair], x)
                if pad:
                    xp = jax.tree.map(
                        lambda a: jnp.concatenate([a] + [a[0:2]] * pad), xp)
                out, res = sm(xp)
                if pad:
                    out = jax.tree.map(lambda a: a[:npair], out)
                    res = res[:npair]
                if odd:
                    carry = jax.tree.map(lambda a: a[lp.count - 1], x)
                    carry = pad_to_device(carry, caps_out[0], caps_out[1],
                                          caps_out[2], caps_out[3])
                    carry = dataclasses.replace(
                        carry, U=carry.U.astype(idt), W=carry.W.astype(idt),
                        V=carry.V.astype(idt))
                    c = (self._regauge_compact(carry, caps_out, idt)
                         if carry_rg
                         else dcompact.compact_device(carry, *caps_out)[0])
                    out = jax.tree.map(
                        lambda a, b: jnp.concatenate([a, b[None]]), out, c)
                    res = jnp.concatenate([res, jnp.zeros((1,), res.dtype)])
                return out, res

            self._progs[key] = jax.jit(prog, in_shardings=in_sh,
                                       out_shardings=(rep, rep))
        elif mode == "tp":
            cfg_tp = cfg._replace(mesh=self.mesh, mesh_axis=self._axis)
            caps_out = lp.caps_out
            rg = lp.regauge[0]
            idt = cfg.info_dtype

            def prog(x: types.LocalMap):  # noqa: ANN001
                g = jax.tree.map(lambda a: a[0], x)
                m = jax.tree.map(lambda a: a[1], x)
                merged, res = self._merge_one(g, m, cfg_tp)
                out = (self._regauge_compact(merged, caps_out, idt) if rg
                       else dcompact.compact_device(merged, *caps_out)[0])
                return jax.tree.map(lambda a: a[None], out), res[None]

            self._progs[key] = jax.jit(prog, in_shardings=in_sh,
                                       out_shardings=(rep, rep))
        else:
            body = self._build_body(lp.count, lp.caps_out, lp.regauge, cfg)
            self._progs[key] = jax.jit(body, in_shardings=in_sh,
                                       out_shardings=(rep, rep))
        return self._progs[key]

    def _final_program(self, caps, need: bool):
        key = ("final", caps, need)
        if key in self._progs:
            return self._progs[key]

        def prog(x: types.LocalMap) -> types.LocalMap:
            root = jax.tree.map(lambda a: a[0], x)
            out = (self._regauge_compact(root, caps, "float64") if need
                   else dcompact.compact_device(root, *caps)[0])
            return dataclasses.replace(
                out, U=out.U.astype(out.poses.dtype),
                W=out.W.astype(out.poses.dtype),
                V=out.V.astype(out.poses.dtype))

        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            rep = NamedSharding(self.mesh, P())
            self._progs[key] = jax.jit(prog, in_shardings=rep,
                                       out_shardings=rep)
        else:
            self._progs[key] = jax.jit(prog)
        return self._progs[key]

    # -- ahead-of-time concurrent compilation --------------------------------
    def ensure_warm(self, tp: plan_mod.TreePlan, x_shape) -> int:
        """AOT-compile every missing level/final program CONCURRENTLY.

        Lowering runs serially on the host (each level's output shape is the
        next one's input); the executables then compile in a thread pool, so
        a cold tree costs about its slowest program instead of the sum, and
        persistent-cache hits load concurrently the same way. A failed
        compile raises. Returns #programs compiled."""
        work = []  # (key, lowered)
        for lp in tp.levels:
            key = self._level_key(lp)[0]
            if key in self._aot:
                x_shape = self._aot[key][1][0]
                continue
            low = self._level_program(lp).lower(x_shape)
            work.append((key, low))
            x_shape = low.out_info[0]  # (map, res) — only the map re-enters
        fkey = ("final", tp.root_caps, tp.root_regauge)
        if fkey not in self._aot:
            low = self._final_program(tp.root_caps, tp.root_regauge).lower(
                x_shape)
            work.append((fkey, low))
        if not work:
            return 0
        t0 = time.time()
        with ThreadPoolExecutor(min(len(work), COMPILE_WORKERS)) as ex:
            futs = [(k, low, ex.submit(low.compile)) for k, low in work]
            for k, low, f in futs:
                self._aot[k] = (f.result(), low.out_info)
        log.info("warm: compiled %d programs in %.1fs", len(work),
                 time.time() - t0)
        return len(work)

    # -- full tree -----------------------------------------------------------
    def run(self, maps: list[types.LocalMap], metrics=None,
            ckpt_dir: str | None = None,
            resume: bool = False,
            time_levels: bool = False) -> types.LocalMap:
        """time_levels: block after each level dispatch and record TRUE
        per-level execution walls into metrics (records' `exec_wall`). The
        default async pipeline records enqueue time only — blocking costs one
        host sync per level, so this is an opt-in profiling mode (bench.py
        runs it once after the timed pass)."""
        t0 = time.time()
        stacked = compact_mod.compact_stack(maps, self.bucket, self.u_bucket)
        t1 = time.time()
        syms = plan_mod.sym_of_stacked(stacked)
        tp = plan_mod.plan_tree_exact(syms, self.datatype, self.bucket,
                                      self.u_bucket,
                                      map_offset=self.plan_offset,
                                      final_regauge=self.final_regauge)
        if not tp:
            return jax.tree.map(lambda a: a[0], stacked)
        plans = tp.levels
        Mi, Ni, KUi, KWi = plans[0].caps_in

        def grow(a, cap, fill=0):
            if a.ndim < 2 or a.shape[1] >= cap:
                return a
            return np.pad(a, [(0, 0), (0, cap - a.shape[1])]
                          + [(0, 0)] * (a.ndim - 2), constant_values=fill)

        stacked = dataclasses.replace(
            stacked,
            pose_ids=grow(stacked.pose_ids, Mi, -1),
            poses=grow(stacked.poses, Mi),
            feat_ids=grow(stacked.feat_ids, Ni, -1),
            feats=grow(stacked.feats, Ni),
            U=grow(stacked.U, KUi), Uij=grow(stacked.Uij, KUi),
            W=grow(stacked.W, KWi), Wpf=grow(stacked.Wpf, KWi),
            V=grow(stacked.V, Ni))
        t2 = time.time()
        x_shape = jax.tree.map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), stacked)
        self.ensure_warm(tp, x_shape)
        t2b = time.time()
        start_level = 0
        if resume and ckpt_dir:
            got = checkpoint.latest_stacked(ckpt_dir)
            if got is not None:
                lvl, st = got
                want = (plans[lvl].count, plans[lvl].caps_in[0]) \
                    if lvl < len(plans) else \
                    ((plans[-1].count + 1) // 2, plans[-1].caps_out[0])
                if st.pose_ids.shape == want:
                    stacked, start_level = st, lvl
                    log.info("resuming at level %d from %s", lvl, ckpt_dir)
                else:
                    log.warning("checkpoint shape %s mismatches plan %s; "
                                "restarting", st.pose_ids.shape, want)
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            x = jax.device_put(stacked, NamedSharding(self.mesh, P()))
        else:
            x = jax.device_put(stacked)
        t3 = time.time()
        res_per_level = {}
        for li, lp in enumerate(plans):
            if li < start_level:
                continue
            tl0 = time.time()
            x, res = self._aot[self._level_key(lp)[0]][0](x)
            exec_wall = None
            if time_levels:
                jax.block_until_ready(x.poses)
                exec_wall = round(time.time() - tl0, 4)
            res_per_level[li + 1] = res   # device-resident; fetched at the end
            if ckpt_dir:
                checkpoint.save_stacked(ckpt_dir, li + 1, jax.device_get(x))
            self.join_count += lp.count // 2
            if metrics is not None:
                extra = {} if exec_wall is None else dict(exec_wall=exec_wall)
                metrics.record(li + 1, (lp.count + 1) // 2, lp.count // 2,
                               M=lp.caps_out[0], N=lp.caps_out[1],
                               join_m=lp.join_m,
                               wall=round(time.time() - t0, 4), **extra)
            if self.progress:
                log.info("Level %d dispatched (%d maps)", li + 1,
                         (lp.count + 1) // 2)
        y = self._aot[("final", tp.root_caps, tp.root_regauge)][0](x)
        t4 = time.time()
        # Fetch only the solution (ids/states/counts/gauge) eagerly; the info
        # blocks stay device-resident jax Arrays and transfer lazily on first
        # np.asarray — the common consumers (writers, ATE, tests) never pay.
        (pose_ids, poses, feat_ids, feats, n_poses, n_feats, n_U, n_W,
         gauge) = jax.device_get(
            (y.pose_ids, y.poses, y.feat_ids, y.feats, y.n_poses, y.n_feats,
             y.n_U, y.n_W, y.gauge))
        host = dataclasses.replace(
            y, pose_ids=pose_ids, poses=poses, feat_ids=feat_ids, feats=feats,
            n_poses=n_poses, n_feats=n_feats, n_U=n_U, n_W=n_W, gauge=gauge)
        # PCG convergence telemetry (SURVEY §5: per-level residual). The
        # [count]-sized residual vectors are fetched once, AFTER the tree —
        # per-level fetches would sync the async level dispatch.
        resh = jax.device_get(res_per_level)
        self.last_residuals = {lv: np.asarray(r) for lv, r in resh.items()}
        if metrics is not None:
            by_level = {r["level"]: r for r in metrics.records}
            for lv, r in self.last_residuals.items():
                if lv in by_level and r.size:
                    with np.errstate(invalid="ignore", all="ignore"):
                        v = float(np.nanmax(r))
                    if np.isfinite(v):
                        by_level[lv]["res_max"] = v
        self._last_timing = dict(compact=round(t1 - t0, 4),
                                 plan=round(t2 - t1, 4),
                                 warm=round(t2b - t2, 4),
                                 upload=round(t3 - t2b, 4),
                                 levels=round(t4 - t3, 4),
                                 get=round(time.time() - t4, 4))
        return host
