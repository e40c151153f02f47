"""Feature-sharded Schur assembly + solve — the TP-analog axis for root joins.

The root joins of NC3500-scale trees have tens of thousands of landmark
blocks; their Schur contributions ``sum_f W_f Vinv_f W_f^T`` dominate the
assembly cost. Here the feature axis is sharded over a mesh axis: each device
computes the partial reduced camera system for its feature shard and the
partials are `psum`'d across the devices; the dense Cholesky then runs
replicated, and feature back-substitution is sharded again.

Two entry points:

* ``sharded_schur_solve`` — grouped (max_obs) assembly + f32 factor with f64
  iterative refinement. Exact enough below ~512-pose joins.
* ``sharded_full_mixed`` — the production root solve: the same
  f32-Schur-factor-preconditioned **f64 PCG on the full information system**
  as ops/schur.solve_full_mixed, with the feature axis sharded. The dense
  per-shard W stripes are f32 matmuls, the PCG matvec is a psum of
  per-shard f64 block-list segment-sums (no f64 matmul anywhere), and the
  triangular solves run replicated. Plain refinement diverges at 1024+-map
  roots (cond * eps_f32 > 1, measured r2); this keeps the multi-chip top
  levels at the same accuracy as the single-device path.

Semantically identical to ops/schur.py's single-device paths (tested against
them); use for single-pair (root) joins, not inside vmapped levels.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import schur
from ..ops.smallmat import bmv, bmv_t


def _partial_schur(U, Uij, Wg, pg, valid, Vinv_g, M):
    """Dense S contribution of a feature shard (grouped arrays)."""
    dtype = U.dtype
    S = jnp.zeros((M, 6, M, 6), dtype)
    ui, uj = Uij[:, 0], Uij[:, 1]
    # U scatter happens on device 0's shard only (replicated inputs would
    # double count under psum) — callers pass zeroed U to other shards.
    S = S.at[ui, :, uj, :].add(U)
    S = S.at[uj, :, ui, :].add(
        jnp.where((ui != uj)[:, None, None], jnp.swapaxes(U, 1, 2), 0.0))

    Wg = Wg * valid[..., None, None]
    Yg = jnp.einsum("nofk,nkl->nofl", Wg, Vinv_g)
    C = jnp.einsum("nofk,npgk->nopfg", Yg, Wg)
    po = jnp.broadcast_to(pg[:, :, None], C.shape[:3])
    pp = jnp.broadcast_to(pg[:, None, :], C.shape[:3])
    S = S.at[po.reshape(-1), :, pp.reshape(-1), :].add(-C.reshape(-1, 6, 6))
    return S.reshape(6 * M, 6 * M)


def sharded_schur_solve(U, Uij, W, Wpf, V, eP, eF, M: int, max_obs: int,
                        mesh: Mesh, axis: str = "fs", fixed_mask=None,
                        method: str = "direct", refine_iters: int = 3):
    """Assemble S/E with the feature axis sharded over `mesh`, solve, and
    back-substitute features. Returns (x_poses[M,6], x_feats[N,3]).
    """
    N = V.shape[0]
    ndev = mesh.devices.size
    Npad = ((N + ndev - 1) // ndev) * ndev

    Vinv = schur.inv3x3_sym(V)
    entry_valid = jnp.any(W != 0, axis=(1, 2))
    entry, valid, overflowed = schur.group_by_feature(
        Wpf, N, max_obs, entry_valid=entry_valid)
    # Undersized max_obs would silently drop Schur terms; poison instead.
    Wg = W[entry] * jnp.where(overflowed, jnp.nan, 1.0).astype(W.dtype)
    pg = Wpf[:, 0][entry]               # [N, O]

    def padf(x):
        pad = [(0, Npad - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, pad)

    Wg, pg, valid, Vinv_p, eF_p = padf(Wg), padf(pg), padf(valid), padf(Vinv), padf(eF)

    # RHS: E = eP - sum_entries (W Vinv) eF  (feature-sharded via the groups)
    def shard_fn(Wg_s, pg_s, valid_s, Vinv_s, eF_s, U_s, Uij_s):
        U_s, Uij_s = U_s[0], Uij_s[0]   # drop the sharded device axis
        S_part = _partial_schur(U_s, Uij_s, Wg_s, pg_s, valid_s, Vinv_s, M)
        Y = jnp.einsum("nofk,nkl->nofl", Wg_s * valid_s[..., None, None], Vinv_s)
        e_part = jax.ops.segment_sum(
            jnp.einsum("nofk,nk->nof", Y, eF_s).reshape(-1, 6),
            pg_s.reshape(-1), num_segments=M)
        S_full = jax.lax.psum(S_part, axis)
        e_full = jax.lax.psum(e_part, axis)
        return S_full, e_full

    # Give the U blocks to shard 0 only (avoid double counting under psum).
    shard_id = jnp.arange(ndev)
    U_sh = jnp.where((shard_id == 0)[:, None, None, None],
                     jnp.broadcast_to(U, (ndev,) + U.shape), 0.0)
    Uij_sh = jnp.broadcast_to(Uij, (ndev,) + Uij.shape)

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P()), check_vma=False)
    S, WVe = fn(Wg, pg, valid, Vinv_p, eF_p, U_sh, Uij_sh)
    E = (eP - WVe).reshape(-1)

    from ..ops import solve as solve_mod
    x = solve_mod.solve_reduced(S, E, fixed_mask=fixed_mask, method=method,
                                refine_iters=refine_iters)
    xp = x.reshape(M, 6)

    # feature backsub, sharded over the same feature axis
    def back_fn(Wg_s, pg_s, valid_s, Vinv_s, eF_s):
        xg = xp[pg_s]                                 # [n, O, 6]
        wtx = jnp.einsum("nofk,nof->nk", Wg_s * valid_s[..., None, None], xg)
        return jnp.einsum("nkl,nl->nk", Vinv_s, eF_s - wtx)

    bf = jax.shard_map(back_fn, mesh=mesh,
                       in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
                       out_specs=P(axis), check_vma=False)
    xf = bf(Wg, pg, valid, Vinv_p, eF_p)[:N]
    return xp, xf


def sharded_full_mixed(U, Uij, W, Wpf, V, eP, eF, M: int, fixed_mask,
                       mesh: Mesh, axis: str = "fs", *, iters: int = 16,
                       fixc=None, sign=None, escalate_iters: int = 0,
                       escalate_tol: float = 1e-8, exit_tol: float = 0.0):
    """Feature-sharded mixed-precision fusion solve (PCG; see module doc).

    Mirrors ops/schur.solve_full_mixed (same preconditioner, same iteration,
    same pin semantics — reference exactness target pba_solveCholmodLM,
    /root/reference/linux/src/LinearSFMImp/LinearSFMImp.cpp:2380-2449) with
    every O(N)/O(K) term computed on the shard that owns the feature range
    and psum'd. Inputs are replicated; each shard masks the entry lists to
    its ownership: W entries by feature range (so the dense Y_s W_s^T
    partials tile the full product), U entries round-robin.

    Returns (x_p[M,6], x_f[N,3]) in the input dtype, replicated.
    """
    from ..ops import solve as solve_mod  # noqa: F401  (parity with schur)

    dt = U.dtype
    f32 = jnp.float32
    N = V.shape[0]
    KU, KW = U.shape[0], W.shape[0]
    nd = mesh.devices.size
    Nl = (N + nd - 1) // nd
    has_fix = fixc is not None
    fixc_in = jnp.asarray(fixc if has_fix else 0, jnp.int32)
    sign_in = jnp.asarray(sign if has_fix else 1.0, dt)

    def body(U, Uij, W, Wpf, V, eP, eF, fixed_mask, fixc, sign):
        # NB everything derived from the operands must be built INSIDE the
        # shard_map body (and traced operands like the mono fixc/sign must be
        # operands, not closures): outside-constructed arrays carry Auto-mesh
        # shardings that the Manual-mesh context rejects on capture.
        ui, uj = Uij[:, 0], Uij[:, 1]
        wp, wf = Wpf[:, 0], Wpf[:, 1]
        offd = (ui != uj)[:, None]
        freeP = (~fixed_mask).reshape(M, 6)
        if has_fix:
            freeP = freeP.reshape(-1).at[fixc].set(False).reshape(M, 6)

        def pin(xp):
            if not has_fix:
                return xp
            flat = xp.reshape(-1).at[fixc].set(sign.astype(xp.dtype))
            return flat.reshape(M, 6)

        d = jax.lax.axis_index(axis)
        lo = d * Nl
        own_w = (wf >= lo) & (wf < lo + Nl)
        own_u = (jnp.arange(KU) % nd) == d
        psum = lambda x: jax.lax.psum(x, axis)

        # Replicated operands are computed redundantly on every device, and
        # on a GPU their scatter-adds reduce in no fixed order, so the copies
        # can differ in their last bits. PCG on such copies mixes slightly
        # different operators across the psums, and the gap between its
        # recursive and true residual grows with cond(I). Take device 0's
        # copy everywhere (adding zeros is exact).
        U, W, V, eP, eF = (psum(jnp.where(d == 0, x, jnp.zeros_like(x)))
                           for x in (U, W, V, eP, eF))

        # ---- f32 preconditioner: per-shard dense stripes + psum'd S --------
        U32 = jnp.where(own_u[:, None, None], U.astype(f32), 0.0)
        W32o = jnp.where(own_w[:, None, None], W.astype(f32), 0.0)
        V32 = V.astype(f32)
        Vinv32 = schur.inv3x3_sym(V32)
        Yb = jnp.einsum("kif,kfl->kil", W32o, Vinv32[wf])
        urow = jnp.where(jnp.any(U32 != 0, axis=(1, 2)), ui, -1)
        wrow = jnp.where(jnp.any(W32o != 0, axis=(1, 2)), wp, -1)
        wcol = jnp.clip(wf - lo, 0, Nl - 1)
        D = schur.densify_blocks(urow, uj, U32, M, M)
        diagU = jnp.where((ui == uj)[:, None, None], U32, 0.0)
        Dd = schur.densify_blocks(urow, uj, diagU, M, M)
        A_part = D + D.T - 0.5 * (Dd + Dd.T)
        Wd = schur.densify_blocks(wrow, wcol, W32o, M, Nl)
        Yd = schur.densify_blocks(wrow, wcol, Yb, M, Nl)
        eFpad = jnp.pad(eF.astype(f32), ((0, Nl * nd - N), (0, 0)))
        eF_s = jax.lax.dynamic_slice_in_dim(eFpad, lo, Nl)
        S32 = psum(A_part - Yd @ Wd.T)
        E32 = eP.astype(f32).reshape(-1) - psum(Yd @ eF_s.reshape(-1))
        if has_fix:
            E32 = E32 - jnp.take(S32, fixc, axis=1) * sign.astype(f32)
        S32, E32 = solve_mod.mask_gauge(S32, E32, fixed_mask)
        d32 = jnp.diag(S32)
        dsc = jnp.where(d32 > 0, jax.lax.rsqrt(jnp.maximum(d32, 1e-30)), 1.0)
        Ss = S32 * dsc[:, None] * dsc[None, :]
        Ss = Ss + (4 * jnp.finfo(f32).eps) * jnp.eye(Ss.shape[0], dtype=f32)
        L = jnp.linalg.cholesky(Ss)

        def sch32(rhs32):
            y = jax.scipy.linalg.solve_triangular(L, rhs32 * dsc, lower=True)
            return dsc * jax.scipy.linalg.solve_triangular(L, y, trans=1,
                                                           lower=True)

        # ---- f64 masked block lists for the exact matvec -------------------
        U64 = jnp.where(own_u[:, None, None], U, 0.0)
        W64 = jnp.where(own_w[:, None, None], W, 0.0)
        W32 = W32o
        Y32 = jnp.einsum("kiz,kzf->kif", W32, Vinv32[wf])

        def precond(rP, rF):
            rF32 = rF.astype(f32)
            red = rP.astype(f32) - psum(jax.ops.segment_sum(
                jnp.einsum("kif,kf->ki", Y32, rF32[wf]), wp, M))
            red = jnp.where(freeP, red, 0.0)
            dxp = sch32(red.reshape(-1)).reshape(M, 6)
            dxp = jnp.where(freeP, dxp, 0.0)
            wtx = psum(jax.ops.segment_sum(
                jnp.einsum("kif,ki->kf", W32, dxp[wp]), wf, N))
            dxf = jnp.einsum("nij,nj->ni", Vinv32, rF32 - wtx)
            return dxp.astype(dt), dxf.astype(dt)

        def matvec(xp, xf):
            xp_ = xp.astype(dt)
            xf_ = xf.astype(dt)
            iPl = jax.ops.segment_sum(bmv(U64, xp_[uj]), ui, M)
            iPl += jax.ops.segment_sum(
                jnp.where(offd, bmv_t(U64, xp_[ui]), 0.0), uj, M)
            iPl += jax.ops.segment_sum(bmv(W64, xf_[wf]), wp, M)
            iFl = jax.ops.segment_sum(bmv_t(W64, xp_[wp]), wf, N)
            iP = psum(iPl)
            iF = psum(iFl) + bmv(V, xf_)   # V term replicated, added once
            return jnp.where(freeP, iP, 0.0), iF

        def dot(aP, aF, bP, bF):
            return jnp.vdot(aP, bP) + jnp.vdot(aF, bF)

        xp0 = pin(sch32(E32).reshape(M, 6).astype(dt))
        # feature init: xf0 = Vinv32 (eF - W^T xp0), sharded like the matvec
        wtx0 = psum(jax.ops.segment_sum(
            jnp.einsum("kif,ki->kf", W32, xp0.astype(f32)[wp]), wf, N))
        xf0 = jnp.einsum("nij,nj->ni", Vinv32,
                         eF.astype(f32) - wtx0).astype(dt)

        iP, iF = matvec(xp0, xf0)
        rP = jnp.where(freeP, eP - iP, 0.0)
        rF = eF - iF
        zP, zF = precond(rP, rF)
        rz0 = dot(rP, rF, zP, zF)
        tiny = jnp.asarray(jnp.finfo(dt).tiny, dt)

        enorm = jnp.maximum(jnp.sqrt(dot(jnp.where(freeP, eP, 0.0), eF,
                                         jnp.where(freeP, eP, 0.0), eF)),
                            tiny)

        def step(carry):
            xp, xf, rP, rF, pP, pF, rz, _res2, i = carry
            qP, qF = matvec(pP, pF)
            pq = dot(pP, pF, qP, qF)
            alpha = jnp.where(pq > 0, rz / jnp.maximum(pq, tiny), 0.0)
            xp = xp + alpha * pP
            xf = xf + alpha * pF
            rP = rP - alpha * qP
            rF = rF - alpha * qF
            zP, zF = precond(rP, rF)
            rz_new = dot(rP, rF, zP, zF)
            beta = jnp.where(rz > 0, rz_new / jnp.maximum(rz, tiny), 0.0)
            pP = zP + beta * pP
            pF = zF + beta * pF
            return (xp, xf, rP, rF, pP, pF, rz_new,
                    dot(rP, rF, rP, rF), i + 1)

        init = (xp0, xf0, rP, rF, zP, zF, rz0, dot(rP, rF, rP, rF),
                jnp.asarray(0, jnp.int32))
        # The residual and counter are replicated across shards, so every
        # device evaluates the same early-exit condition (no divergence).
        if exit_tol:
            tol2 = (jnp.asarray(exit_tol, dt) * enorm) ** 2
            carry = jax.lax.while_loop(
                lambda c: (c[8] < iters) & (c[7] > tol2), step, init)
        else:
            carry = jax.lax.fori_loop(0, iters, lambda _, c: step(c), init)

        def _res(c):
            return jnp.sqrt(c[7]) / enorm

        if escalate_iters:
            carry = jax.lax.cond(
                _res(carry) > escalate_tol,
                lambda c: jax.lax.fori_loop(0, escalate_iters,
                                            lambda _, cc: step(cc), c),
                lambda c: c, carry)
        xp, xf = carry[:2]
        return pin(xp), xf, _res(carry)

    from ..ops import solve as solve_mod
    fn = jax.shard_map(body, mesh=mesh,
                       in_specs=(P(),) * 10, out_specs=(P(), P(), P()),
                       check_vma=False)
    xp, xf, res = fn(U, Uij, W, Wpf, V, eP, eF, fixed_mask, fixc_in, sign_in)
    return xp, xf, res
