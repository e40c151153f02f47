"""Pairwise map joining: the exactly-linear least-squares fusion.

Reference semantics (lmj_LinearLS_PF3DStereo,
/root/reference/linux/src/LinearSFMImp/LinearSFMImp.cpp:2551-2978;
lmj_LinearLS_PF3DMono :7282-7874):

Given the accumulated map `end` already re-expressed in `cur`'s gauge and the
incoming local map `cur`, stack the two information forms and solve once:
``x* = (I_end + I_cur)^{-1} (I_end x_end + I_cur x_cur)`` via feature-Schur +
dense Cholesky. The result is an *absolute* state (no iteration, no initial
guess — the problem is genuinely linear, :2360).

Static-shape differences from the reference bookkeeping:

* Feature matching by id via sort + searchsorted (replacing the O(n1*n2)
  std::find loop :2581-2599); everything is static-shape with masks.
* Mono pose identification keeps `cur`'s ref/scap slots as dead (zero-info,
  gauge-masked) slots instead of compacting to m1+m2-2 — numerically identical,
  shape-static.
* Dropped zero-information blocks (everything touching the reference pose,
  :7482, :7531, :7619, :7678) are zeroed, not removed.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp

from .. import types
from ..ops import schur, solve
from ..ops.rotations import wrap_angle_pi, wrap_angle_diff


class JoinConfig(NamedTuple):
    max_obs: int = 8          # max W entries per feature in the Schur grouping
    method: str = "direct"    # "direct" | "refine"
    refine_iters: int = 3
    # Optional device mesh for feature-sharded Schur assembly (root joins);
    # None = single-device path. Must not be combined with vmapped levels.
    mesh: object | None = None
    mesh_axis: str = "fs"
    # Mono scale-pin conditioning. "sign": condition the solve on the pinned
    # coordinate's actual value (E -= S[:,fix]*sign) — exact constrained
    # fusion. "zero": drop the column like the reference
    # (LinearSFMImp.cpp:6994-7021), exact only when the pinned coordinate has
    # no information coupling (true for the reference's datasets).
    pin: str = "sign"
    # Force the dense-W Schur assembly regardless of system size (the
    # device-resident tree uses this: no per-level max_obs statistics needed).
    dense_schur: bool = False
    # Information-path dtype ("float32"/"float64"/None=inherit from inputs).
    # The solved state is always emitted in the state dtype; f32 info is the
    # low-tree-level fast path where cond(S) is small (core/device_tree.py).
    info_dtype: str | None = None
    # Convergence telemetry/escalation (method="refine"): when with_res the
    # join returns (map, res_rel) where res_rel is the solve's final relative
    # residual (nan on paths that don't compute one); escalate_iters > 0 runs
    # that many extra PCG sweeps iff res_rel > escalate_tol (lax.cond — the
    # converged path never pays). See ops/schur.solve_full_mixed.
    with_res: bool = False
    escalate_iters: int = 0
    escalate_tol: float = 1e-8
    # PCG early exit (method="refine"): > 0 makes refine_iters a CAP — the
    # sweep loop stops as soon as the relative f64 residual drops below
    # exit_tol (lax.while_loop). The top tree levels converge to 1e-15..1e-23
    # well before the 16-sweep cap (bench telemetry), so the device executor
    # sets a near-machine exit there. 0 = fixed trip count.
    exit_tol: float = 0.0


def _match_features(end_ids, end_valid, cur_ids, cur_valid, n1, out_cap):
    """Joint slot for every `cur` feature.

    Returns (joint_idx[N2], matched[N2]): matched features map to the `end`
    slot holding the same id; new features are appended from slot `n1` (the
    count of valid end features, which are contiguous at the front) in `cur`
    order. Invalid (padding) features map to `out_cap` — out of range, so
    scatters with mode="drop" ignore them (gathers must clip).
    """
    big = jnp.iinfo(jnp.int32).max
    key = jnp.where(end_valid, end_ids, big)
    order = jnp.argsort(key)
    sorted_ids = key[order]
    pos = jnp.searchsorted(sorted_ids, cur_ids)
    pos_c = jnp.clip(pos, 0, end_ids.shape[0] - 1)
    hit = (sorted_ids[pos_c] == cur_ids) & cur_valid
    end_slot = order[pos_c]

    new = cur_valid & ~hit
    new_rank = jnp.cumsum(new.astype(jnp.int32)) - 1
    joint = jnp.where(hit, end_slot, n1 + jnp.where(new, new_rank, 0))
    joint = jnp.where(cur_valid, joint, out_cap)
    return joint.astype(jnp.int32), hit


def join_stereo(end: types.LocalMap, cur: types.LocalMap,
                cfg: JoinConfig = JoinConfig()) -> types.LocalMap:
    """Fuse two stereo maps sharing the same reference gauge."""
    M1, M2, N1, N2 = end.M, cur.M, end.N, cur.N
    Mo, No = M1 + M2, N1 + N2

    end_fvalid = end.feat_mask()
    cur_fvalid = cur.feat_mask()
    joint2, matched = _match_features(end.feat_ids, end_fvalid,
                                      cur.feat_ids, cur_fvalid, end.n_feats, No)
    ncom = jnp.sum(matched.astype(jnp.int32))
    joint2g = jnp.clip(joint2, 0, No - 1)  # gather-safe (pads hit zero blocks)

    # ---- states & ids ------------------------------------------------------
    pose_ids = jnp.concatenate([end.pose_ids, cur.pose_ids])
    poses = jnp.concatenate([end.poses, cur.poses])
    feat_ids = jnp.full((No,), -1, jnp.int32)
    feat_ids = feat_ids.at[:N1].set(end.feat_ids)
    feat_ids = feat_ids.at[joint2].set(cur.feat_ids, mode="drop")
    # (feature values are solver outputs; no need to merge priors here)

    # ---- information blocks ------------------------------------------------
    idt = jnp.dtype(cfg.info_dtype) if cfg.info_dtype else end.U.dtype
    ic = lambda x: x.astype(idt)
    U = jnp.concatenate([ic(end.U), ic(cur.U)])
    Uij = jnp.concatenate([end.Uij, cur.Uij + M1])
    W = jnp.concatenate([ic(end.W), ic(cur.W)])
    Wpf2 = jnp.stack([cur.Wpf[:, 0] + M1, joint2g[cur.Wpf[:, 1]]], axis=1)
    Wpf = jnp.concatenate([end.Wpf, Wpf2])
    V = jnp.zeros((No, 3, 3), idt)
    V = V.at[:N1].set(ic(end.V))
    V = V.at[joint2].add(ic(cur.V), mode="drop")

    # ---- information vectors e = I x per map (LinearSFMImp.cpp:2645-2931) --
    eP1, eF1 = schur.info_vector(end.poses, end.feats, ic(end.U), end.Uij,
                                 ic(end.W), end.Wpf, ic(end.V))
    eP2, eF2 = schur.info_vector(cur.poses, cur.feats, ic(cur.U), cur.Uij,
                                 ic(cur.W), cur.Wpf, ic(cur.V))
    eP = jnp.concatenate([eP1, eP2])
    eF = jnp.zeros((No, 3), idt)
    eF = eF.at[:N1].set(eF1)
    eF = eF.at[joint2].add(eF2, mode="drop")

    # ---- Schur + solve -----------------------------------------------------
    n_poses = end.n_poses + cur.n_poses
    pose_valid = jnp.concatenate([end.pose_mask(), cur.pose_mask()])
    fixed = ~jnp.repeat(pose_valid, 6)
    res = jnp.nan
    if cfg.mesh is not None:
        from ..parallel import shard_solve
        if cfg.method == "refine":
            # production accuracy: feature-sharded full-system PCG (plain
            # sharded refinement diverges at 1024+-map roots)
            xp, xf, res = shard_solve.sharded_full_mixed(
                U, Uij, W, Wpf, V, eP, eF, Mo, fixed, mesh=cfg.mesh,
                axis=cfg.mesh_axis, iters=cfg.refine_iters,
                escalate_iters=cfg.escalate_iters,
                escalate_tol=cfg.escalate_tol, exit_tol=cfg.exit_tol)
        else:
            xp, xf = shard_solve.sharded_schur_solve(
                U, Uij, W, Wpf, V, eP, eF, Mo, cfg.max_obs, cfg.mesh,
                axis=cfg.mesh_axis, fixed_mask=fixed, method=cfg.method,
                refine_iters=cfg.refine_iters)
    elif cfg.method == "refine":
        # f32 dense assembly + factorization, f64 block-list PCG — no f64
        # matmul anywhere (ops/schur.solve_full_mixed).
        xp, xf, res = schur.solve_full_mixed(
            U, Uij, W, Wpf, V, eP, eF, Mo, fixed, max_obs=cfg.max_obs,
            force_dense=cfg.dense_schur, iters=cfg.refine_iters,
            escalate_iters=cfg.escalate_iters,
            escalate_tol=cfg.escalate_tol, exit_tol=cfg.exit_tol)
    else:
        Vinv = schur.inv3x3_sym(V)
        S, E = schur.assemble_schur(U, Uij, W, Wpf, Vinv, eP, eF, Mo,
                                    cfg.max_obs, force_dense=cfg.dense_schur)
        x = solve.solve_reduced(S, E, fixed_mask=fixed, method=cfg.method,
                                refine_iters=cfg.refine_iters)
        xp = x.reshape(Mo, 6)
        xf = schur.backsub_features(W, Wpf, Vinv, eF, xp)
    xp = xp.astype(end.dtype)
    xf = xf.astype(end.dtype)

    out = types.LocalMap(
        pose_ids=pose_ids, poses=xp, feat_ids=feat_ids, feats=xf,
        U=U, Uij=Uij, W=W, Wpf=Wpf, V=V,
        n_poses=n_poses, n_feats=end.n_feats + cur.n_feats - ncom,
        n_U=jnp.asarray(U.shape[0], jnp.int32), n_W=jnp.asarray(W.shape[0], jnp.int32),
        gauge=dataclasses.replace(end.gauge, ref=cur.gauge.ref),
    )
    return (out, jnp.asarray(res, xp.dtype)) if cfg.with_res else out


def join_mono(end: types.LocalMap, cur: types.LocalMap,
              cfg: JoinConfig = JoinConfig()) -> types.LocalMap:
    """Fuse two mono maps sharing the same (ref, scap, fix) gauge.

    `end` must already be expressed in `cur`'s gauge (so
    end.gauge.{ref,scap,fix} == cur.gauge.{ref,scap,fix}).
    """
    M1, M2, N1, N2 = end.M, cur.M, end.N, cur.N
    Mo, No = M1 + M2, N1 + N2
    dtype = end.dtype

    ref_id, scap_id, fix = end.gauge.ref, end.gauge.scap, end.gauge.fix
    pos1 = end.ref_slot()       # End's reference slot (posID1, :7309-7311)
    pos2 = end.scap_slot()      # End's scale-pose slot (posID2)
    cref = cur.ref_slot()
    cscap = cur.scap_slot()

    # ---- angle wraparound on the scale-pose blocks (:7427-7465) -----------
    # (jnp.asarray: inputs may be host/numpy-backed when called un-jitted)
    end_poses = jnp.asarray(end.poses).at[pos2, 3:6].set(
        wrap_angle_pi(end.poses[pos2, 3:6]))
    cur_ang = wrap_angle_pi(cur.poses[cscap, 3:6])
    cur_ang = wrap_angle_diff(cur_ang, end_poses[pos2, 3:6])
    cur_poses = jnp.asarray(cur.poses).at[cscap, 3:6].set(cur_ang)

    # ---- drop zero-information blocks touching the reference pose ---------
    idt = jnp.dtype(cfg.info_dtype) if cfg.info_dtype else end.U.dtype
    ic = lambda x: x.astype(idt)
    end_keep_u = (end.Uij[:, 0] != pos1) & (end.Uij[:, 1] != pos1)
    endU = jnp.where(end_keep_u[:, None, None], ic(end.U), 0.0)
    end_keep_w = end.Wpf[:, 0] != pos1
    endW = jnp.where(end_keep_w[:, None, None], ic(end.W), 0.0)
    cur_keep_u = (cur.Uij[:, 0] != cref) & (cur.Uij[:, 1] != cref)
    curU = jnp.where(cur_keep_u[:, None, None], ic(cur.U), 0.0)
    cur_keep_w = cur.Wpf[:, 0] != cref
    curW = jnp.where(cur_keep_w[:, None, None], ic(cur.W), 0.0)

    # ---- pose identification: cur's ref/scap -> end's slots (:7383-7409) ---
    slotmap2 = jnp.arange(M2, dtype=jnp.int32) + M1
    slotmap2 = jnp.where(jnp.arange(M2) == cref, pos1, slotmap2)
    slotmap2 = jnp.where(jnp.arange(M2) == cscap, pos2, slotmap2)

    # ---- feature matching --------------------------------------------------
    end_fvalid = end.feat_mask()
    cur_fvalid = cur.feat_mask()
    joint2, matched = _match_features(end.feat_ids, end_fvalid,
                                      cur.feat_ids, cur_fvalid, end.n_feats, No)
    ncom = jnp.sum(matched.astype(jnp.int32))
    joint2g = jnp.clip(joint2, 0, No - 1)  # gather-safe

    # ---- states & ids ------------------------------------------------------
    pose_ids = jnp.concatenate([end.pose_ids, cur.pose_ids])
    # cur's ref/scap slots become dead: invalidate their ids
    dead2 = (jnp.arange(M2) == cref) | (jnp.arange(M2) == cscap)
    pose_ids = pose_ids.at[M1:].set(jnp.where(dead2, -1, cur.pose_ids))
    poses = jnp.concatenate([end_poses, cur_poses])

    feat_ids = jnp.full((No,), -1, jnp.int32)
    feat_ids = feat_ids.at[:N1].set(end.feat_ids)
    feat_ids = feat_ids.at[joint2].set(cur.feat_ids, mode="drop")

    # ---- information blocks ------------------------------------------------
    U = jnp.concatenate([endU, curU])
    Uij2 = slotmap2[cur.Uij]
    Uij = jnp.concatenate([end.Uij, Uij2])
    W = jnp.concatenate([endW, curW])
    Wpf2 = jnp.stack([slotmap2[cur.Wpf[:, 0]], joint2g[cur.Wpf[:, 1]]], axis=1)
    Wpf = jnp.concatenate([end.Wpf, Wpf2])
    V = jnp.zeros((No, 3, 3), idt)
    V = V.at[:N1].set(ic(end.V))
    V = V.at[joint2].add(ic(cur.V), mode="drop")

    # ---- information vectors (post-drop, post-wraparound) ------------------
    eP1, eF1 = schur.info_vector(end_poses, end.feats, endU, end.Uij, endW,
                                 end.Wpf, ic(end.V))
    eP2, eF2 = schur.info_vector(cur_poses, cur.feats, curU, cur.Uij, curW,
                                 cur.Wpf, ic(cur.V))
    eP = jnp.zeros((Mo, 6), idt)
    eP = eP.at[:M1].set(eP1)
    eP = eP.at[slotmap2].add(eP2)
    eF = jnp.zeros((No, 3), idt)
    eF = eF.at[:N1].set(eF1)
    eF = eF.at[joint2].add(eF2, mode="drop")

    # ---- Schur + gauge-masked solve (:6981-7026) ---------------------------
    pose_valid = jnp.concatenate(
        [end.pose_mask(), cur.pose_mask() & ~dead2])
    fixed = ~jnp.repeat(pose_valid, 6)
    coord = jnp.arange(Mo * 6)
    fixed |= (coord >= 6 * pos1) & (coord < 6 * pos1 + 6)   # reference block
    fixc = 6 * pos2 + fix
    fixed |= coord == fixc                                  # pinned scale coord
    sign = jnp.asarray(end.gauge.sign).astype(idt)
    res = jnp.nan
    if cfg.mesh is not None:
        from ..parallel import shard_solve
        if cfg.method == "refine" and cfg.pin == "sign":
            xp, xf, res = shard_solve.sharded_full_mixed(
                U, Uij, W, Wpf, V, eP, eF, Mo, fixed, mesh=cfg.mesh,
                axis=cfg.mesh_axis, iters=cfg.refine_iters,
                fixc=fixc, sign=sign, escalate_iters=cfg.escalate_iters,
                escalate_tol=cfg.escalate_tol, exit_tol=cfg.exit_tol)
        else:
            # NB with gauge-conditioned inputs the pinned coordinate carries
            # zero information, so no RHS correction is needed here.
            xp, xf = shard_solve.sharded_schur_solve(
                U, Uij, W, Wpf, V, eP, eF, Mo, cfg.max_obs, cfg.mesh,
                axis=cfg.mesh_axis, fixed_mask=fixed, method=cfg.method,
                refine_iters=cfg.refine_iters)
            xp = xp.at[pos2, :].set(
                jnp.where(jnp.arange(6) == fix, sign, xp[pos2, :]))
    elif cfg.method == "refine" and cfg.pin == "sign":
        xp, xf, res = schur.solve_full_mixed(
            U, Uij, W, Wpf, V, eP, eF, Mo, fixed, max_obs=cfg.max_obs,
            force_dense=cfg.dense_schur, iters=cfg.refine_iters,
            fixc=fixc, sign=sign, escalate_iters=cfg.escalate_iters,
            escalate_tol=cfg.escalate_tol, exit_tol=cfg.exit_tol)
    else:
        Vinv = schur.inv3x3_sym(V)
        S, E = schur.assemble_schur(U, Uij, W, Wpf, Vinv, eP, eF, Mo,
                                    cfg.max_obs, force_dense=cfg.dense_schur)
        if cfg.pin == "sign":
            E = E - jnp.take(S, fixc, axis=1) * sign
        x = solve.solve_reduced(S, E, fixed_mask=fixed, method=cfg.method,
                                refine_iters=cfg.refine_iters)
        xp = x.reshape(Mo, 6)
        if cfg.pin == "sign":
            # exact constrained fusion: back-substitute with the pinned
            # coordinate at its actual value
            xp = xp.at[pos2, :].set(jnp.where(jnp.arange(6) == fix, sign, xp[pos2, :]))
            xf = schur.backsub_features(W, Wpf, Vinv, eF, xp)
        else:
            # reference order: backsub with the pinned coordinate still at 0,
            # stVal[Fix] = Sign afterwards (:7010-7026)
            xf = schur.backsub_features(W, Wpf, Vinv, eF, xp)
            xp = xp.at[pos2, :].set(jnp.where(jnp.arange(6) == fix, sign, xp[pos2, :]))
    xp = xp.astype(dtype)
    xf = xf.astype(dtype)

    out = types.LocalMap(
        pose_ids=pose_ids, poses=xp, feat_ids=feat_ids, feats=xf,
        U=U, Uij=Uij, W=W, Wpf=Wpf, V=V,
        n_poses=end.n_poses + cur.n_poses - 2,
        n_feats=end.n_feats + cur.n_feats - ncom,
        n_U=jnp.asarray(U.shape[0], jnp.int32), n_W=jnp.asarray(W.shape[0], jnp.int32),
        # gauge tags from cur (GMap_Joint.Ref/ScaP/Fix/Sign = GMap_Cur.*,
        # :7365-7369); final-frame tags from end (:7371-7373).
        gauge=dataclasses.replace(
            cur.gauge, fref=end.gauge.fref, fscap=end.gauge.fscap,
            ffix=end.gauge.ffix),
    )
    return (out, jnp.asarray(res, xp.dtype)) if cfg.with_res else out
