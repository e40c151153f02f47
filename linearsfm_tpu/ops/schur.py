"""Information-form fusion solve: feature-Schur complement as dense matmuls.

Mirrors the semantics of lmj_solveLinearSFMStereo
(/root/reference/linux/src/LinearSFMImp/LinearSFMImp.cpp:2119-2378) and
lmj_solveLinearSFMMono (:6756-7041) in static-shape batched form:

* ``V^{-1}``: batched closed-form symmetric 3x3 inverse (pba_inverseV :3022).
* ``S = U - W V^{-1} W^T``: scatter-add of U blocks plus per-feature grouped
  outer products, assembled densely as [6M, 6M] — every non-root join in the
  bundled datasets fits comfortably; the root joins use the same code at
  f32-with-refinement precision (see solve.py).
* ``E = eP - W V^{-1} eF`` (:2320-2328).
* Mono gauge elimination: instead of deleting the 7 gauge rows/cols
  (:6981-7021), mask them to identity rows with zero RHS — numerically
  identical, shape-static.
* Feature back-substitution ``x_f = V^{-1}(eF_f - W^T x_p)``
  (pba_solveFeatures :2980-3020).

All functions take zero-padded block lists (padding contributes nothing).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from .smallmat import bmv, bmv_t


def inv3x3_sym(V: jax.Array) -> jax.Array:
    """Batched closed-form inverse of 3x3 blocks, symmetrized on output
    (pba_inverseV symmetrizes too, LinearSFMImp.cpp:3035-3040).

    Padding guard: blocks that are exactly zero return zero (pseudo-inverse
    of the zero block), so padded features stay inert.
    """
    a, b, c = V[..., 0, 0], V[..., 0, 1], V[..., 0, 2]
    d, e, f = V[..., 1, 1], V[..., 1, 2], V[..., 2, 2]
    # cofactors of the symmetrized matrix
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    det = a * A + b * B + c * C
    zero = det == 0
    inv_det = jnp.where(zero, 0.0, 1.0 / jnp.where(zero, 1.0, det))
    row0 = jnp.stack([A, B, C], axis=-1)
    row1 = jnp.stack([B, D, E], axis=-1)
    row2 = jnp.stack([C, E, F], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2) * inv_det[..., None, None]


def info_vector(poses, feats, U, Uij, W, Wpf, V):
    """(eP[M,6], eF[N,3]) = I @ x, accumulated blockwise like the join loops
    (LinearSFMImp.cpp:2669-2907). Runs in the information dtype (states are
    cast down to match — otherwise a mixed-precision U would silently promote
    the products back to f64)."""
    poses = poses.astype(U.dtype)
    feats = feats.astype(U.dtype)
    M, N = poses.shape[0], feats.shape[0]
    ui, uj = Uij[:, 0], Uij[:, 1]
    wp, wf = Wpf[:, 0], Wpf[:, 1]
    offd = (ui != uj)[:, None]

    # bmv/bmv_t (broadcast-multiply-sum, ops/smallmat.py), NOT einsum: these
    # run in f64 at the upper tree levels, and the design keeps f64 products
    # off dot_general (see ops/smallmat.py for why and what is still open).
    eP = jax.ops.segment_sum(bmv(U, poses[uj]), ui, M)
    eP += jax.ops.segment_sum(
        jnp.where(offd, bmv_t(U, poses[ui]), 0.0), uj, M)
    eP += jax.ops.segment_sum(bmv(W, feats[wf]), wp, M)

    eF = bmv(V, feats)
    eF += jax.ops.segment_sum(bmv_t(W, poses[wp]), wf, N)
    return eP, eF


# Feature-chunking budget for the pairwise Schur products, in [chunk, O, O]
# 6x6 blocks: 2^16 blocks hold 18.9 MB of f64 (9.4 MB of f32) per chunk.
_SCHUR_CHUNK_BLOCKS = 1 << 16

# Above this scalar dimension the pairwise grouped path loses to dense
# matmuls: scatter W into a dense [6M,3N] and multiply (see
# _assemble_schur_dense).
_DENSE_SCHUR_DIM = 1024


def _dense_w_bytes() -> int:
    """Byte budget of one dense [6M, 3Nc] f32 stripe: 1/32 of the device's
    memory, so the chunked assembly's live stripes (Wd + Yd) hold about 1/16
    of it and the rest stays free for the level's block lists, S and its
    factor. Read at trace time from the allocator's limit; the CPU backend
    has the host's physical memory."""
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    else:
        stats = dev.memory_stats() or {}
        if "bytes_limit" not in stats:
            raise RuntimeError(
                f"{dev.device_kind} reports no memory limit; cannot size the "
                "dense Schur assembly stripes")
        total = stats["bytes_limit"]
    return total // 32


def group_by_feature(Wpf, N: int, max_obs: int, entry_valid=None):
    """Static-shape grouping of W entries by feature.

    Returns (entry_idx[N, max_obs], valid[N, max_obs]) where entry_idx selects
    W rows for each feature (arbitrary order), padded with 0.

    `entry_valid[KW]` masks padding entries (they would otherwise crowd the
    bucket of feature 0, whose slot index padding reuses). A valid entry
    beyond `max_obs` for its feature would silently corrupt the Schur sum, so
    any such overflow POISONS the validity mask with NaN-producing weights
    (see assemble_schur) — callers size `max_obs` from host-side metadata
    (TreeSolver._max_obs_per_feature is exact) and an undersized bound
    surfaces as NaNs, never as a quietly-wrong solution.

    Works on traced arrays: rank-within-feature is computed by sorting.
    Returns (entry[N,max_obs], valid[N,max_obs], overflowed[scalar bool]).
    """
    KW = Wpf.shape[0]
    f = Wpf[:, 1]
    if entry_valid is not None:
        f = jnp.where(entry_valid, f, N)  # route pads to a dummy bucket
    # stable sort by feature; rank within each feature = position - first pos
    order = jnp.argsort(f, stable=True)
    fs = f[order]
    pos = jnp.arange(KW)
    # first occurrence index of each feature value in sorted array
    first = jax.ops.segment_min(pos, fs, num_segments=N + 1)
    rank = pos - first[fs]
    ok = (rank < max_obs) & (fs < N)
    overflowed = jnp.any((rank >= max_obs) & (fs < N))
    col = jnp.where(ok, rank, 0)
    row = jnp.where(ok, fs, N)
    entry = jnp.zeros((N + 1, max_obs), jnp.int32)
    entry = entry.at[row, col].set(jnp.where(ok, order, 0).astype(jnp.int32), mode="drop")
    valid = jnp.zeros((N + 1, max_obs), bool)
    valid = valid.at[row, col].set(ok, mode="drop")
    return entry[:N], valid[:N], overflowed


def densify_blocks(rows, cols, vals, M: int, N: int):
    """Dense [R*M, C*N] from a block-COO list (scatter-add semantics).

    rows < 0 = padding (skipped); duplicate (row, col) entries accumulate.
    One element-flattened scatter-add: R*C scalars per block.
    """
    K, R, C = vals.shape
    rR = jnp.arange(R)
    rC = jnp.arange(C)
    rr = jnp.broadcast_to(rows[:, None, None] * R + rR[None, :, None],
                          (K, R, C))
    cc = jnp.broadcast_to(cols[:, None, None] * C + rC[None, None, :],
                          (K, R, C))
    # jax .at[] WRAPS negative indices (NumPy semantics) — a -1 row would
    # land on the last row, not be dropped. Route padding to R*M (positive
    # out-of-range) so mode="drop" really skips it.
    rr = jnp.where((rows >= 0)[:, None, None], rr, R * M)
    out = jnp.zeros((R * M, C * N), vals.dtype)
    return out.at[rr.reshape(-1), cc.reshape(-1)].add(
        vals.reshape(-1), mode="drop")


def _assemble_schur_dense(U, Uij, W, Wpf, Vinv, eP, eF, M: int):
    """Large-join Schur path: dense [6M,3N] W and two dense matmuls.

    Densifies the block lists into clean 2-D layouts (densify_blocks) and
    computes ``S = A - (W Vinv) W^T`` with two big dot products — the
    layout/throughput-optimal form once the reduced system is root-sized.
    A's lower triangle comes from a dense transpose (sym_complete), not from
    a second scatter of the transposed blocks.
    """
    N = Vinv.shape[0]
    dtype = U.dtype
    ui, uj = Uij[:, 0], Uij[:, 1]
    wp, wf = Wpf[:, 0], Wpf[:, 1]

    Yb = jnp.einsum("kif,kfl->kil", W, Vinv[wf])

    def sym_complete(D, urow):
        """A = D + D^T with the double-counted diagonal blocks subtracted.

        The correction is block-diagonal by construction, so it is
        accumulated as a [M,6,6] segment-sum and subtracted on the block
        diagonal — NOT densified into a second full [6M,6M] matrix (which
        would double the assembly's peak memory at the largest roots).
        Symmetrized (0.5*(d+d^T)) so the diagonal blocks come out exactly
        symmetric even when post-f32-congruence blocks are not.
        """
        dmask = (ui == uj) & (urow >= 0)
        diag = jax.ops.segment_sum(
            jnp.where(dmask[:, None, None], U, 0.0),
            jnp.where(dmask, ui, M), num_segments=M + 1)[:M]
        corr = 0.5 * (diag + jnp.swapaxes(diag, 1, 2))
        # Subtract on the block diagonal via a flat M*36-element scatter,
        # keeping the matrix 2-D.
        im6 = jnp.arange(M)[:, None, None] * 6
        r6 = jnp.arange(6)
        rows = jnp.broadcast_to(im6 + r6[None, :, None], (M, 6, 6))
        cols = jnp.broadcast_to(im6 + r6[None, None, :], (M, 6, 6))
        return (D + D.T).at[rows.reshape(-1), cols.reshape(-1)].add(
            -corr.reshape(-1))

    # Zero-valued entries (list padding, dropped couplings) are routed to
    # row -1 and skipped by the densification.
    urow = jnp.where(jnp.any(U != 0, axis=(1, 2)), ui, -1)
    A = sym_complete(densify_blocks(urow, uj, U, M, M), urow)
    wvalid = jnp.any(W != 0, axis=(1, 2))

    # Large f32 roots (the f32 preconditioner of solve_full_mixed): two dense
    # [6M, 3N] matrices can exceed the device's memory (4.9 GB each at
    # M=4100, N=49k). Chunk the FEATURE axis: densify and multiply
    # [6M, 3*Nc] stripes, accumulating S and the RHS term — peak memory
    # bounded by the stripe, the same FLOPs in Nc-wide slabs.
    nch = 1
    if dtype == jnp.float32:
        nch = max(1, -(-(6 * M * 3 * N * 4) // _dense_w_bytes()))
    if nch == 1:
        wrow = jnp.where(wvalid, wp, -1)
        Wd = densify_blocks(wrow, wf, W, M, N)
        Yd = densify_blocks(wrow, wf, Yb, M, N)
        return A - Yd @ Wd.T, eP.reshape(-1) - Yd @ eF.reshape(-1)

    Nc = -(-N // nch)
    nch = -(-N // Nc)
    eFp = jnp.pad(eF, ((0, Nc * nch - N), (0, 0)))

    def body(c, carry):
        S, e = carry
        lo = c * Nc
        own = wvalid & (wf >= lo) & (wf < lo + Nc)
        wrow = jnp.where(own, wp, -1)
        wcol = jnp.clip(wf - lo, 0, Nc - 1)
        Wd = densify_blocks(wrow, wcol, W, M, Nc)
        Yd = densify_blocks(wrow, wcol, Yb, M, Nc)
        eFc = jax.lax.dynamic_slice_in_dim(eFp, lo, Nc)
        return (S - Yd @ Wd.T, e - Yd @ eFc.reshape(-1))

    return jax.lax.fori_loop(0, nch, body,
                             (A, eP.reshape(-1).astype(dtype)))


def assemble_schur(U, Uij, W, Wpf, Vinv, eP, eF, M: int, max_obs: int,
                   force_dense: bool = False):
    """Dense reduced camera system: S[6M,6M], E[6M].

    S = scatter(U) - sum_f W_f Vinv_f W_f^T, grouped per feature with a static
    max-observation bound (matches the reference's per-feature double loop,
    LinearSFMImp.cpp:2244-2332). Root-scale joins (and the device-resident
    tree, which has no per-level max_obs statistics) use the dense-W path
    (_assemble_schur_dense).
    """
    N = Vinv.shape[0]
    dtype = U.dtype
    if force_dense or 6 * M >= _DENSE_SCHUR_DIM:
        return _assemble_schur_dense(U, Uij, W, Wpf, Vinv, eP, eF, M)
    ui, uj = Uij[:, 0], Uij[:, 1]
    wp, wf = Wpf[:, 0], Wpf[:, 1]

    S = jnp.zeros((M, 6, M, 6), dtype)
    S = S.at[ui, :, uj, :].add(U)
    S = S.at[uj, :, ui, :].add(jnp.where((ui != uj)[:, None, None], jnp.swapaxes(U, 1, 2), 0.0))

    # Entries with an exactly-zero block (padding or dropped couplings)
    # contribute nothing; exclude them so they don't crowd feature buckets.
    entry_valid = jnp.any(W != 0, axis=(1, 2))
    entry, valid, overflowed = group_by_feature(Wpf, N, max_obs,
                                                entry_valid=entry_valid)
    # Undersized max_obs would silently drop Schur terms; poison instead.
    poison = jnp.where(overflowed, jnp.nan, 1.0).astype(dtype)
    Wg = W[entry] * valid[..., None, None] * poison  # [N, O, 6, 3]
    pg = wp[entry]                                  # [N, O]

    # Pairwise outer products W_f Vinv_f W_f^T, accumulated in feature chunks:
    # the [N, O, O, 6, 6] tensor is O(N * max_obs^2) and overflows memory at root
    # scale if materialized whole.
    chunk = max(1, min(N, _SCHUR_CHUNK_BLOCKS // max(1, max_obs * max_obs)))
    nch = (N + chunk - 1) // chunk
    Np = nch * chunk

    def padc(x):
        return jnp.pad(x, [(0, Np - x.shape[0])] + [(0, 0)] * (x.ndim - 1))

    Wg_p, pg_p, Vinv_p = padc(Wg), padc(pg), padc(Vinv)

    def body(c, S):
        sl = lambda x: jax.lax.dynamic_slice_in_dim(x, c * chunk, chunk)
        Wc, pc, Vc = sl(Wg_p), sl(pg_p), sl(Vinv_p)
        Yc = jnp.einsum("nofk,nkl->nofl", Wc, Vc)
        C = jnp.einsum("nofk,npgk->nopfg", Yc, Wc)   # [chunk, O, O, 6, 6]
        po = jnp.broadcast_to(pc[:, :, None], C.shape[:3])
        pp = jnp.broadcast_to(pc[:, None, :], C.shape[:3])
        return S.at[po.reshape(-1), :, pp.reshape(-1), :].add(-C.reshape(-1, 6, 6))

    S = jax.lax.fori_loop(0, nch, body, S) if nch > 1 else body(0, S)

    Y = jnp.einsum("kiz,kzf->kif", W, Vinv[wf])      # W V^-1 per entry
    E = eP - jax.ops.segment_sum(jnp.einsum("kif,kf->ki", Y, eF[wf]), wp, M)
    return S.reshape(6 * M, 6 * M), E.reshape(6 * M)


def solve_full_mixed(U, Uij, W, Wpf, V, eP, eF, M: int, fixed_mask, *,
                     max_obs: int = 1, force_dense: bool = False,
                     iters: int = 3, fixc=None, sign=None,
                     escalate_iters: int = 0, escalate_tol: float = 1e-8,
                     exit_tol: float = 0.0):
    """Mixed-precision fusion solve: f32 Schur factor + full-system f64 PCG.

    The reference factorizes the reduced camera system in f64 CHOLMOD
    (pba_solveCholmodLM, LinearSFMImp.cpp:2380-2449). This design was chosen
    for a machine whose f64 matmuls ran at ~f32 precision: it keeps EVERY
    matmul in f32 and recovers accuracy with **conjugate gradients in f64 on
    the full information system**, preconditioned by the f32 Schur
    factorization:

      matvec:   r = I x via the f64 block lists (exact elementwise
                segment-sums — no f64 dense matrix, no f64 matmul anywhere);
      M^{-1} r: dx_p = S32^{-1}(r_P - W V^{-1} r_F),
                dx_f = V32^{-1}(r_F - W^T dx_p)   (all f32 matmuls).

    On the H100, f64 matmuls are native, so the plain f64 dense
    factorization (method="direct") is exact too; which of the two is faster
    per tree level is an open measurement.

    PCG contracts like sqrt(cond(M^{-1} I)) ~ sqrt(1 + cond(I) eps_f32) per
    iteration — it keeps converging where plain iterative refinement
    (Richardson) diverges once cond * eps_f32 > 1 (measured: 1024-map stereo
    root, cond ~ 1e10). The f32 factor is stabilized by symmetric diagonal
    equilibration plus a tiny jitter so it stays PD even when S is
    numerically indefinite in f32 (2048-map roots NaN'd without it); the
    jitter only perturbs the preconditioner, never the answer.

    Args:
      U..eF: block-sparse information + info vectors in the accumulation
        dtype (f64 at the upper tree levels).
      fixed_mask: bool[6M], True = gauge-fixed coordinate (solution pinned).
      fixc, sign: mono scale pin — scalar index into [6M] and the +-1 value
        the pinned coordinate takes (join_mono pin="sign" semantics).
      escalate_iters/escalate_tol: convergence control — the reference gets
        an exact factorization for free (pba_solveCholmodLM,
        LinearSFMImp.cpp:2444); here, if after `iters` sweeps the relative
        f64 residual still exceeds `escalate_tol`, run `escalate_iters` more
        (a lax.cond, so the healthy path never pays). The residual is free:
        PCG maintains r = e - I x as loop state.
      exit_tol: early exit — when > 0 the sweep loop is a lax.while_loop
        that stops as soon as the relative f64 residual drops below it
        (`iters` becomes a cap, not a count). The top tree levels cap at 16
        sweeps but measured residuals land at 1e-15..1e-23 well before the
        cap (BENCH r5 telemetry), so a near-machine exit (1e-14) halves the
        dominant root-level cost with no accuracy change at printed
        precision. 0 keeps the fixed-trip fori_loop (bit-stable paths for
        equivalence tests).

    Returns (x_p[M,6], x_f[N,3], res_rel) in the input dtype; res_rel is the
    final full-system relative residual ||e - I x|| / ||e|| (f64 scalar) —
    surfaced so executors can record per-level convergence (SURVEY §5).
    """
    from . import solve as solve_mod

    dt = U.dtype
    f32 = jnp.float32
    N = V.shape[0]
    wp, wf = Wpf[:, 0], Wpf[:, 1]

    U32, W32, V32 = U.astype(f32), W.astype(f32), V.astype(f32)
    Vinv32 = inv3x3_sym(V32)
    S32, E32 = assemble_schur(U32, Uij, W32, Wpf, Vinv32,
                              eP.astype(f32), eF.astype(f32), M,
                              max_obs, force_dense=force_dense)
    if fixc is not None:
        E32 = E32 - jnp.take(S32, fixc, axis=1) * jnp.asarray(sign, f32)
    S32, E32 = solve_mod.mask_gauge(S32, E32, fixed_mask)
    # Equilibrate + jitter: Ss = D S D with D = diag(S)^{-1/2}; unit diagonal
    # keeps the f32 pivots O(1) and the 4*eps32 jitter keeps Cholesky PD.
    d32 = jnp.diag(S32)
    dsc = jnp.where(d32 > 0, jax.lax.rsqrt(jnp.maximum(d32, 1e-30)), 1.0)
    Ss = S32 * dsc[:, None] * dsc[None, :]
    Ss = Ss + (4 * jnp.finfo(f32).eps) * jnp.eye(Ss.shape[0], dtype=f32)
    L = jnp.linalg.cholesky(Ss)

    def sch32(rhs32):
        # trans=1 on the SAME L buffer — `solve_triangular(L.T, ...)` would
        # materialize a transposed copy (1.8 GB at the 3499-map roots).
        y = jax.scipy.linalg.solve_triangular(L, rhs32 * dsc, lower=True)
        return dsc * jax.scipy.linalg.solve_triangular(L, y, trans=1,
                                                       lower=True)

    freeP = (~fixed_mask).reshape(M, 6)
    if fixc is not None:
        freeP = freeP.reshape(-1).at[fixc].set(False).reshape(M, 6)

    def pin(xp):
        if fixc is None:
            return xp
        flat = xp.reshape(-1).at[fixc].set(jnp.asarray(sign, xp.dtype))
        return flat.reshape(M, 6)

    xp0 = pin(sch32(E32).reshape(M, 6).astype(dt))
    xf0 = backsub_features(W32, Wpf, Vinv32, eF.astype(f32),
                           xp0.astype(f32)).astype(dt)

    Y32 = jnp.einsum("kiz,kzf->kif", W32, Vinv32[wf])

    def precond(rP, rF):
        """M^{-1} r with the f32 Schur factor; zero at fixed coords."""
        rF32 = rF.astype(f32)
        red = rP.astype(f32) - jax.ops.segment_sum(
            jnp.einsum("kif,kf->ki", Y32, rF32[wf]), wp, M)
        red = jnp.where(freeP, red, 0.0)
        dxp = sch32(red.reshape(-1)).reshape(M, 6)
        dxp = jnp.where(freeP, dxp, 0.0)
        wtx = jax.ops.segment_sum(
            jnp.einsum("kif,ki->kf", W32, dxp[wp]), wf, N)
        dxf = jnp.einsum("nij,nj->ni", Vinv32, rF32 - wtx)
        return dxp.astype(dt), dxf.astype(dt)

    def matvec(xp, xf):
        iP, iF = info_vector(xp, xf, U, Uij, W, Wpf, V)
        return jnp.where(freeP, iP, 0.0), iF

    def dot(aP, aF, bP, bF):
        return jnp.vdot(aP, bP) + jnp.vdot(aF, bF)

    # initial residual of the full system at (xp0, xf0), fixed coords pinned
    iP, iF = info_vector(xp0, xf0, U, Uij, W, Wpf, V)
    rP = jnp.where(freeP, eP - iP, 0.0)
    rF = eF - iF
    zP, zF = precond(rP, rF)
    rz0 = dot(rP, rF, zP, zF)
    tiny = jnp.asarray(jnp.finfo(dt).tiny, dt)

    enorm = jnp.sqrt(dot(jnp.where(freeP, eP, 0.0), eF,
                         jnp.where(freeP, eP, 0.0), eF))
    enorm = jnp.maximum(enorm, tiny)

    def body(carry):
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
    if exit_tol:
        tol2 = (jnp.asarray(exit_tol, dt) * enorm) ** 2
        carry = jax.lax.while_loop(
            lambda c: (c[8] < iters) & (c[7] > tol2), body, init)
    else:
        carry = jax.lax.fori_loop(0, iters, lambda _, c: body(c), init)

    def _res(c):
        return jnp.sqrt(c[7]) / enorm

    if escalate_iters:
        carry = jax.lax.cond(
            _res(carry) > escalate_tol,
            lambda c: jax.lax.fori_loop(0, escalate_iters,
                                        lambda _, cc: body(cc), c),
            lambda c: c, carry)
    xp, xf = carry[:2]
    return pin(xp), xf, _res(carry)


def backsub_features(W, Wpf, Vinv, eF, x_poses):
    """x_f = Vinv_f (eF_f - sum W^T x_p) (pba_solveFeatures)."""
    x_poses = x_poses.astype(W.dtype)
    N = Vinv.shape[0]
    wp, wf = Wpf[:, 0], Wpf[:, 1]
    wtx = jax.ops.segment_sum(bmv_t(W, x_poses[wp]), wf, N)
    return bmv(Vinv, eF - wtx)
