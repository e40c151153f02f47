"""Dense-blocked map algebra: gauge congruence + fusion solve as dense products.

The list-based path (ops/congruence.py, ops/schur.py) mirrors the reference's
COO block lists. The lists force sorts/scatters (compaction, dense Schur
assembly) that can dominate wall-clock while the actual FLOPs are trivial.
This module is the dense-blocked data plane used by the planned executor
(core/dense_tree.py): a map's information matrix is carried as

    A[M,6,M,6]   full symmetric pose-pose matrix (both triangles),
    Wd[M,N,6,3]  pose-feature blocks,
    V[N,3,3]     feature-feature block diagonal,

so the congruence ``I' = J^T I J`` (lmj_Transform_PF3DStereo,
/root/reference/linux/src/LinearSFMImp/LinearSFMImp.cpp:349-1924;
lmj_Transform_PF3DMono :3173-6509) is a handful of einsums, and the Schur
complement (lmj_solveLinearSFMStereo :2119-2378) is two dense matmuls. All
slot indices (reference slots, gauge slots) arrive as host-planned scalars
(core/layout.py); nothing here searches ids.

Zero padding is inert everywhere: padded pose/feature slots carry zero rows
and columns of A/Wd/V, so they contribute nothing to products or solves.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import gauge as G


class DenseMap(NamedTuple):
    """Value-only dense map (layout/ids live on the host planner)."""
    poses: jax.Array   # f[M,6]
    feats: jax.Array   # f[N,3]
    A: jax.Array       # f[M,6,M,6]  full symmetric
    Wd: jax.Array      # f[M,N,6,3]
    V: jax.Array       # f[N,3,3]
    sign: jax.Array    # f scalar (mono scale sign; +1 stereo)

    @property
    def M(self) -> int:
        return self.poses.shape[0]

    @property
    def N(self) -> int:
        return self.feats.shape[0]


# ---------------------------------------------------------------------------
# Contractions
#
# Every congruence product contracts over a tiny axis (block width 6 or 3).
# This module was designed for a machine whose f64 dot_general ran at ~f32
# precision with broadcast operands (see ops/smallmat.py), so f64
# contractions are written as broadcast-multiply-reduce over the big operand
# (elementwise, bandwidth-bound, exact f64), looping the tiny free axes;
# f32 keeps einsum. On the H100 f64 is native; not re-measured there.
# ---------------------------------------------------------------------------

def _f64(x) -> bool:
    return x.dtype == jnp.float64


def _accum(n, term):
    """sum(term(k) for k in range(n)) as a fori_loop.

    Unrolling these sums bloats the HLO enough that a tree level of
    unrolled broadcast-reduce contractions failed to compile; the loop form
    is ~n x smaller and the per-iteration kernels are identical.
    """
    t0 = term(0)
    return jax.lax.fori_loop(1, n, lambda k, acc: acc + term(k), t0)


def _ix(x, axis, k):
    return jax.lax.dynamic_index_in_dim(x, k, axis, keepdims=False)


def _sandwich_A(Dp, A):
    """Dp^T A Dp blockwise: "pai,paqb->piqb" + "piqb,qbj->piqj"."""
    if not _f64(A):
        T = jnp.einsum("pai,paqb->piqb", Dp, A)
        return jnp.einsum("piqb,qbj->piqj", T, Dp)
    T = _accum(6, lambda a: _ix(Dp, 1, a)[:, :, None, None]
               * _ix(A, 1, a)[:, None, :, :])
    return _accum(6, lambda b: _ix(T, 3, b)[:, :, :, None]
                  * _ix(Dp, 1, b)[None, None, :, :])


def _sandwich_W(Dp, Wd, Df):
    """Dp^T W Df blockwise: [M,N,6,3]."""
    if not _f64(Wd):
        T = jnp.einsum("pai,pnab->pnib", Dp, Wd)
        return jnp.einsum("pnib,nbj->pnij", T, Df)
    T = _accum(6, lambda a: _ix(Dp, 1, a)[:, None, :, None]
               * _ix(Wd, 2, a)[:, :, None, :])        # [M,N,6i,3b]
    return _accum(3, lambda b: _ix(T, 3, b)[:, :, :, None]
                  * _ix(Df, 1, b)[None, :, None, :])


def _sandwich_V(Df, V):
    if not _f64(V):
        return jnp.einsum("nai,nab,nbj->nij", Df, V, Df)
    T = _accum(3, lambda a: _ix(Df, 1, a)[:, :, None]
               * _ix(V, 1, a)[:, None, :])
    return _accum(3, lambda b: _ix(T, 2, b)[:, :, None]
                  * _ix(Df, 1, b)[:, None, :])


def _stackloop(n, body, axis=-1):
    """stack([body(j) for j in range(n)], axis) as a fori_loop (see _accum)."""
    t0 = body(0)
    out = jnp.zeros(t0.shape + (n,), t0.dtype)
    out = out.at[..., 0].set(t0)
    out = jax.lax.fori_loop(
        1, n, lambda j, o: o.at[..., j].set(body(j)), out)
    return out if axis in (-1, out.ndim - 1) else jnp.moveaxis(out, -1, axis)


def _colA(A, Cp):
    """"paqb,qbj->paj": per-pose-row coupling from the pose-pose matrix."""
    if not _f64(A):
        return jnp.einsum("paqb,qbj->paj", A, Cp)
    return _stackloop(6, lambda j: jnp.sum(
        A * _ix(Cp, 2, j)[None, None, :, :], axis=(2, 3)))


def _colW(Wd, Cf):
    """"pnab,nbj->paj"."""
    if not _f64(Wd):
        return jnp.einsum("pnab,nbj->paj", Wd, Cf)
    return _stackloop(6, lambda j: jnp.sum(
        Wd * _ix(Cf, 2, j)[None, :, None, :], axis=(1, 3)))


def _qW(Cp, Wd):
    """"pai,pnaf->nif"."""
    if not _f64(Wd):
        return jnp.einsum("pai,pnaf->nif", Cp, Wd)
    return _stackloop(6, lambda i: jnp.sum(
        _ix(Cp, 2, i)[:, None, :, None] * Wd, axis=(0, 2)), axis=1)


def _qV(Cf, V):
    """"nai,naf->nif"."""
    if not _f64(V):
        return jnp.einsum("nai,naf->nif", Cf, V)
    return _stackloop(6, lambda i: jnp.sum(
        _ix(Cf, 2, i)[:, :, None] * V, axis=1), axis=1)


def _ct_small(Ca, T):
    """"pix,piy->xy" with x,y tiny: safe as broadcast-reduce."""
    return jnp.sum(Ca[:, :, :, None] * T[:, :, None, :], axis=(0, 1))


def _crossWW(Wd, Cbf):
    """"pnij,njb->pib"."""
    if not _f64(Wd):
        return jnp.einsum("pnij,njb->pib", Wd, Cbf)
    return _stackloop(6, lambda b: jnp.sum(
        Wd * _ix(Cbf, 2, b)[None, :, None, :], axis=(1, 3)))


def _crossWT(Wd, Cbp):
    """"pnij,pib->njb"."""
    if not _f64(Wd):
        return jnp.einsum("pnij,pib->njb", Wd, Cbp)
    return _stackloop(6, lambda b: jnp.sum(
        Wd * _ix(Cbp, 2, b)[:, None, :, None], axis=(0, 2)))


def _VC(V, Cf):
    """"nij,njb->nib"."""
    if not _f64(V):
        return jnp.einsum("nij,njb->nib", V, Cf)
    return _accum(3, lambda j: _ix(V, 2, j)[:, :, None]
                  * _ix(Cf, 1, j)[:, None, :])


# ---------------------------------------------------------------------------
# Congruence
# ---------------------------------------------------------------------------

def _congruence_dense(A, Wd, V, Dp, Df, Cp, Cf, rs, C2p=None, C2f=None,
                      ss=None):
    """Dense ``I' = J^T I J`` with J = blockdiag(Dp,Df) + C e_rs^T (+ C2 e_ss^T).

    Same algebra as ops/congruence.congruence_emit, expressed densely. The
    coupling columns land in pose column `rs` (and `ss` for mono); both
    triangles are written (A is carried full-symmetric). Callers must have
    applied the fold rule (Cp[rs] = 0, and for mono C2p[ss] = 0) beforehand.
    """
    A1 = _sandwich_A(Dp, A)
    W1 = _sandwich_W(Dp, Wd, Df)
    V1 = _sandwich_V(Df, V)

    def column_terms(Cp_, Cf_):
        # Mr[p] = sum_q A[p,q] C_q + sum_n Wd[p,n] Cf_n  -> [M,6,6]
        mr = _colA(A, Cp_) + _colW(Wd, Cf_)
        # Qr[n] = sum_p Cp_p^T Wd[p,n] + Cf_n^T V_n      -> [N,6,3]
        q = _qW(Cp_, Wd) + _qV(Cf_, V)
        return mr, q

    def cross(Ca_p, Ca_f, Cb_p, Cb_f):
        # Ca^T I Cb summed over the full (both-triangle) matrix -> [6,6]
        t = _ct_small(Ca_p, _colA(A, Cb_p))          # pia,piqj,qjb
        t += _ct_small(Ca_p, _crossWW(Wd, Cb_f))     # pia,pnij,njb
        t += _ct_small(Ca_f, _crossWT(Wd, Cb_p))     # nja,pnij,pib
        t += _ct_small(Ca_f, _VC(V, Cb_f))           # nia,nij,njb
        return t

    def add_column(A1, W1, Cp_, Cf_, col_slot):
        mr, q = column_terms(Cp_, Cf_)
        col = jnp.einsum("pai,paj->pij", Dp, mr)    # block at (p, col_slot)
        roww = jnp.einsum("naf,nfj->naj", q, Df)    # block at (col_slot, n)
        A1 = A1.at[:, :, col_slot, :].add(col)
        # symmetric completion: A1[col_slot, a, p, b] += col[p, b, a]
        A1 = A1.at[col_slot, :, :, :].add(
            jnp.transpose(col, (2, 0, 1)))
        W1 = W1.at[col_slot].add(roww)
        return A1, W1

    A1, W1 = add_column(A1, W1, Cp, Cf, rs)
    A1 = A1.at[rs, :, rs, :].add(cross(Cp, Cf, Cp, Cf))

    if C2p is not None:
        A1, W1 = add_column(A1, W1, C2p, C2f, ss)
        A1 = A1.at[ss, :, ss, :].add(cross(C2p, C2f, C2p, C2f))
        rs_ = cross(Cp, Cf, C2p, C2f)
        A1 = A1.at[rs, :, ss, :].add(rs_)
        A1 = A1.at[ss, :, rs, :].add(rs_.T)
    return A1, W1, V1


# ---------------------------------------------------------------------------
# Full map transforms (host-planned slots; no id searches)
# ---------------------------------------------------------------------------

def transform_dense_stereo(dm: DenseMap, rs, info_dtype=None) -> DenseMap:
    """Re-express `dm` in the frame of the pose at slot `rs` and propagate the
    information (lmj_Transform_PF3DStereo, LinearSFMImp.cpp:349-1924).

    `rs` is the host-planned slot of the NEW reference pose; after the
    transform that slot holds the OLD reference (:416-417) — a pure host-side
    retag (core/layout.py), invisible here.
    """
    g = dm.poses[rs]
    new_poses = jax.vmap(G.stereo_pose_block, in_axes=(0, None))(dm.poses, g)
    new_feats = jax.vmap(G.stereo_feat_block, in_axes=(0, None))(dm.feats, g)
    new_poses = new_poses.at[rs].set(G.invpose(g))

    q = new_poses[rs]
    Dp, Cp = jax.vmap(jax.jacfwd(G.stereo_pose_block, argnums=(0, 1)),
                      in_axes=(0, None))(new_poses, q)
    Df, Cf = jax.vmap(jax.jacfwd(G.stereo_feat_block, argnums=(0, 1)),
                      in_axes=(0, None))(new_feats, q)
    Dinv = jax.jacfwd(G.invpose)(q)
    Dp = Dp.at[rs].set(Dinv)
    Cp = Cp.at[rs].set(0.0)

    idt = jnp.dtype(info_dtype) if info_dtype is not None else dm.A.dtype
    c = lambda x: x.astype(idt)
    A1, W1, V1 = _congruence_dense(c(dm.A), c(dm.Wd), c(dm.V),
                                   c(Dp), c(Df), c(Cp), c(Cf), rs)
    return DenseMap(new_poses, new_feats, A1, W1, V1, dm.sign)


def transform_dense_mono(dm: DenseMap, rs, ss, p1, p2, old_fix, new_fix,
                         info_dtype=None) -> DenseMap:
    """Mono gauge+scale transform (lmj_Transform_PF3DMono,
    LinearSFMImp.cpp:3173-6509) with host-planned slots:

      rs, ss: slots of the OLD reference / scale pose (coupling columns),
      p1, p2: slots of the NEW reference / scale pose (gauge conditioning),
      old_fix/new_fix: pinned coordinate before/after.
    """
    g = dm.poses[p1]
    s = dm.poses[p2, 0:3]
    _, sign = G.mono_scale(g, s, new_fix)
    new_poses = jax.vmap(G.mono_pose_block, in_axes=(0, None, None, None))(
        dm.poses, g, s, new_fix)
    new_feats = jax.vmap(G.mono_feat_block, in_axes=(0, None, None, None))(
        dm.feats, g, s, new_fix)
    # Exact gauge pinning (LinearSFMImp.cpp:3282-3294).
    new_poses = new_poses.at[p1].set(jnp.zeros(6, dm.poses.dtype))
    new_poses = new_poses.at[p2, :].set(
        jnp.where(jnp.arange(6) == new_fix, sign, new_poses[p2, :]))

    q = new_poses[rs]
    sv = new_poses[ss, 0:3]
    Dp, Cp, C2p3 = jax.vmap(jax.jacfwd(G.mono_pose_block, argnums=(0, 1, 2)),
                            in_axes=(0, None, None, None))(new_poses, q, sv,
                                                           old_fix)
    Df, Cf, C2f3 = jax.vmap(jax.jacfwd(G.mono_feat_block, argnums=(0, 1, 2)),
                            in_axes=(0, None, None, None))(new_feats, q, sv,
                                                           old_fix)
    C2p = jnp.concatenate([C2p3, jnp.zeros_like(C2p3)], axis=2)
    C2f = jnp.concatenate([C2f3, jnp.zeros_like(C2f3)], axis=2)

    # Folds at the gauge rows (LinearSFMImp.cpp:3495-3525, :3558-3569).
    Dp = Dp.at[rs].add(Cp[rs])
    Cp = Cp.at[rs].set(0.0)
    Dp = Dp.at[ss].add(C2p[ss])
    C2p = C2p.at[ss].set(0.0)

    # Gauge-conditioning projection (LinearSFMImp.cpp:3691-3710): zero every
    # J column of a NEW gauge coordinate (see ops/congruence.py for why this
    # is load-bearing: it makes the mono solver's 7-row deletion exact).
    fixv = jnp.asarray(new_fix, jnp.int32)
    Dp = Dp.at[p1].set(0.0)
    Dp = Dp.at[p2, :, :].set(
        jnp.where(jnp.arange(6)[None, :] == fixv, 0.0, Dp[p2]))
    colfix = jnp.arange(6)[None, None, :] == fixv
    Cp = jnp.where(rs == p2, jnp.where(colfix, 0.0, Cp), Cp)
    Cf = jnp.where(rs == p2, jnp.where(colfix, 0.0, Cf), Cf)
    Cp = jnp.where(rs == p1, 0.0, Cp)
    Cf = jnp.where(rs == p1, 0.0, Cf)
    C2p = jnp.where(ss == p2, jnp.where(colfix, 0.0, C2p), C2p)
    C2f = jnp.where(ss == p2, jnp.where(colfix, 0.0, C2f), C2f)
    C2p = jnp.where(ss == p1, 0.0, C2p)
    C2f = jnp.where(ss == p1, 0.0, C2f)

    idt = jnp.dtype(info_dtype) if info_dtype is not None else dm.A.dtype
    c = lambda x: x.astype(idt)
    A1, W1, V1 = _congruence_dense(c(dm.A), c(dm.Wd), c(dm.V),
                                   c(Dp), c(Df), c(Cp), c(Cf), rs,
                                   C2p=c(C2p), C2f=c(C2f), ss=ss)
    return DenseMap(new_poses, new_feats, A1, W1, V1,
                    sign.astype(dm.poses.dtype))


# ---------------------------------------------------------------------------
# Fusion solve on the dense representation
# ---------------------------------------------------------------------------

def _matvecs(A, Wd, V, xp, xf):
    """(A xp + W xf, W^T xp + V xf) — broadcast-reduce in f64 (see above)."""
    if not _f64(A):
        eP = (jnp.einsum("piqj,qj->pi", A, xp)
              + jnp.einsum("pnif,nf->pi", Wd, xf))
        eF = (jnp.einsum("nij,nj->ni", V, xf)
              + jnp.einsum("pnif,pi->nf", Wd, xp))
        return eP, eF
    eP = (jnp.sum(A * xp[None, None, :, :], axis=(2, 3))
          + jnp.sum(Wd * xf[None, :, None, :], axis=(1, 3)))
    eF = (jnp.sum(V * xf[:, None, :], axis=2)
          + jnp.sum(Wd * xp[:, None, :, None], axis=(0, 2)))
    return eP, eF


def info_vector_dense(dm: DenseMap, idt):
    """e = I x as dense matvecs (cf. ops/schur.info_vector)."""
    idt = jnp.dtype(idt)
    return _matvecs(dm.A.astype(idt), dm.Wd.astype(idt), dm.V.astype(idt),
                    dm.poses.astype(idt), dm.feats.astype(idt))


def solve_dense(A, Wd, V, eP, eF, fixed_mask, *, method="refine",
                refine_iters: int = 3, fixc=None, sign=None):
    """Fuse-and-solve on the dense rep: feature-Schur + Cholesky.

    ``S = A - Wd Vinv Wd^T``, ``E = eP - Wd Vinv eF`` (lmj_solveLinearSFMStereo,
    LinearSFMImp.cpp:2244-2332); gauge rows masked to identity
    (mask_gauge; mono 7-row deletion :6981-7021 via fixed_mask + fixc pin).

    method="direct": everything in the input dtype.
    method="refine": f32 assembly + factorization, full-precision
    recovery by iterative refinement with residuals from the input-dtype
    (f64) dense blocks — dense analog of ops/schur.solve_full_mixed.

    Returns (x_p[M,6], x_f[N,3]) in the input dtype.
    """
    from . import schur as schur_mod
    from . import solve as solve_mod

    dt = A.dtype
    M, N = eP.shape[0], eF.shape[0]
    f32 = jnp.float32
    wdt = f32 if method == "refine" else dt

    Aw, Ww, Vw = A.astype(wdt), Wd.astype(wdt), V.astype(wdt)
    Vinv = schur_mod.inv3x3_sym(Vw)
    Yd = jnp.einsum("pnif,nfg->pnig", Ww, Vinv)
    S = Aw.reshape(6 * M, 6 * M) - jnp.einsum(
        "pnig,qnjg->piqj", Yd, Ww).reshape(6 * M, 6 * M)
    E = (eP.astype(wdt) - jnp.einsum("pnig,ng->pi", Yd, eF.astype(wdt))
         ).reshape(-1)
    if fixc is not None:
        E = E - jnp.take(S, fixc, axis=1) * jnp.asarray(sign, wdt)
    S, E = solve_mod.mask_gauge(S, E, fixed_mask)
    L = jnp.linalg.cholesky(S)

    def sch(rhs):
        y = jax.scipy.linalg.solve_triangular(L, rhs, lower=True)
        return jax.scipy.linalg.solve_triangular(L.T, y, lower=False)

    freeP = (~fixed_mask).reshape(M, 6)

    def pin(xp):
        if fixc is None:
            return xp
        flat = xp.reshape(-1).at[fixc].set(jnp.asarray(sign, xp.dtype))
        return flat.reshape(M, 6)

    xp = pin(sch(E).reshape(M, 6).astype(dt))
    xf = jnp.einsum("nij,nj->ni", Vinv,
                    eF.astype(wdt) - jnp.einsum("pnif,pi->nf", Ww,
                                                xp.astype(wdt))).astype(dt)
    if method != "refine":
        return xp, xf

    def body(_, carry):
        xp, xf = carry
        iP, iF = _matvecs(A, Wd, V, xp, xf)
        rP = (eP - iP).astype(f32)
        rF = (eF - iF).astype(f32)
        red = rP - jnp.einsum("pnig,ng->pi", Yd, rF)
        red = jnp.where(freeP, red, 0.0)
        dxp = sch(red.reshape(-1)).reshape(M, 6)
        dxf = jnp.einsum("nij,nj->ni", Vinv,
                         rF - jnp.einsum("pnif,pi->nf", Ww, dxp))
        return xp + dxp.astype(dt), xf + dxf.astype(dt)

    xp, xf = jax.lax.fori_loop(0, refine_iters, body, (xp, xf))
    return pin(xp), xf
