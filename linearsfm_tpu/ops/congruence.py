"""Information-matrix congruence transform ``I' = J^T I J`` as batched einsums.

The Jacobian J of a gauge transform is block-sparse: a diagonal block ``D_i``
per state block, plus coupling columns ``C_i`` (to the old-reference pose slot
``r``) and, for mono, ``C2_i`` (to the old scale-pose slot ``s``). The
reference hand-unrolls the resulting products over ~5,000 lines
(/root/reference/linux/src/LinearSFMImp/LinearSFMImp.cpp:686-1923, :3739-6503);
here they are a handful of einsums and segment-sums over the block lists,
with scatter-add COO semantics (symmetric completion: an off-diagonal block
(i,j) implies its transpose at (j,i); diagonal blocks do not).

Emission layout (static shapes; zero-valued padding is harmless everywhere):

* stereo:  U' = [transformed U | per-pose (i,r) couplings | (r,r)]
           W' = [transformed W | per-feature (r,f) couplings]
  matching the reference's growth nU+m / nW+n (:694-699 and survey).
* mono:    U' = [transformed U | (i,r) | (i,s) | (r,r) | (s,s) | (r,s)]
           W' = [transformed W | (r,f) | (s,f)]

Fold rule: the row of the old-ref slot has its coupling folded into its
diagonal block (``D[r] += C[r]; C[r] = 0``), same for the scale pose — this is
what the reference does by special-casing ``i == pos3 / pos4`` (:3495-3507).
"""

from __future__ import annotations

import dataclasses


import jax
import jax.numpy as jnp

from .. import types
from . import gauge as G
from .smallmat import bmm, bmm_tn, congr


def _seg(vals, idx, num):
    return jax.ops.segment_sum(vals, idx, num_segments=num)


def congruence_emit(U, Uij, W, Wpf, V, Dp, Df, Cp, Cf, r_slot,
                    C2p=None, C2f=None, s_slot=None):
    """Apply the congruence and emit new block lists.

    Args:
      U[KU,6,6], Uij[KU,2], W[KW,6,3], Wpf[KW,2], V[N,3,3]: info blocks.
      Dp[M,6,6], Df[N,3,3]: folded diagonal Jacobian blocks.
      Cp[M,6,6], Cf[N,3,6]: couplings to the old-ref column (zero at row r).
      C2p/C2f: mono couplings to the old scale-pose column (zero at row s).
      r_slot, s_slot: traced slot indices of the coupling columns.

    Returns dict with transformed lists and appended couplings.
    """
    M = Dp.shape[0]
    N = Df.shape[0]
    ui, uj = Uij[:, 0], Uij[:, 1]
    wp, wf = Wpf[:, 0], Wpf[:, 1]
    offdiag = (ui != uj)[:, None, None]

    Dui, Duj = Dp[ui], Dp[uj]
    Dwp, Dwf = Dp[wp], Df[wf]

    # Transformed existing blocks: D_i^T B D_j. All block contractions here
    # go through ops/smallmat (broadcast-multiply-sum), a design chosen for a
    # machine whose f64 dot_general ran at ~f32: the congruence products ARE
    # the information path. On the H100 f64 einsum is native; whether the
    # elementwise form still pays is open (see ops/smallmat.py).
    U_t = congr(Dui, U, Duj)
    W_t = congr(Dwp, W, Dwf)
    V_t = congr(Df, V, Df)

    def couplings(Cp_, Cf_):
        # M_[i] = sum_j I_ij C_j  (pose rows); Q_[f] = sum_i C_i^T I_if (feat rows).
        mr = _seg(bmm(U, Cp_[uj]), ui, M)
        mr += _seg(jnp.where(offdiag, bmm_tn(U, Cp_[ui]), 0.0), uj, M)
        mr += _seg(bmm(W, Cf_[wf]), wp, M)
        q = _seg(bmm_tn(Cp_[wp], W), wf, N)  # C_p^T W_pf -> [N,6,3]
        q += bmm_tn(Cf_, V)
        return mr, q

    # sum over all blocks (both orientations of off-diagonal blocks) of
    # Ca_i^T I_ij Cb_j — the scalar accumulators (r,r)/(s,s)/(r,s).
    def cross(Ca_p, Ca_f, Cb_p, Cb_f):
        t = jnp.sum(congr(Ca_p[ui], U, Cb_p[uj]), axis=0)
        t += jnp.sum(congr(jnp.where(offdiag, Ca_p[uj], 0.0),
                           jnp.swapaxes(U, 1, 2), Cb_p[ui]), axis=0)
        t += jnp.sum(congr(Ca_p[wp], W, Cb_f[wf]), axis=0)
        t += jnp.sum(congr(Ca_f[wf], jnp.swapaxes(W, 1, 2), Cb_p[wp]), axis=0)
        t += jnp.sum(congr(Ca_f, V, Cb_f), axis=0)
        return t

    mr, qr = couplings(Cp, Cf)
    newU_r = bmm_tn(Dp, mr)                           # D_i^T M_r[i], coords (i, r)
    # Diagonal emission (i == r) needs explicit symmetrisation (no completion).
    at_r = (jnp.arange(M) == r_slot)[:, None, None]
    newU_r = jnp.where(at_r, newU_r + jnp.swapaxes(newU_r, 1, 2), newU_r)
    newW_r = bmm(qr, Df)                              # coords (r, f)
    rr = cross(Cp, Cf, Cp, Cf)

    out = dict(U_t=U_t, W_t=W_t, V_t=V_t, newU_r=newU_r, newW_r=newW_r, rr=rr)

    if C2p is not None:
        ms, qs = couplings(C2p, C2f)
        newU_s = bmm_tn(Dp, ms)
        at_s = (jnp.arange(M) == s_slot)[:, None, None]
        newU_s = jnp.where(at_s, newU_s + jnp.swapaxes(newU_s, 1, 2), newU_s)
        newW_s = bmm(qs, Df)
        ss = cross(C2p, C2f, C2p, C2f)
        rs = cross(Cp, Cf, C2p, C2f)
        out.update(newU_s=newU_s, newW_s=newW_s, ss=ss, rs=rs)
    return out


# --------------------------------------------------------------------------
# Full map transforms (state + information).
# --------------------------------------------------------------------------

def _jacs_stereo(new_poses, new_feats, q):
    """All stereo Jacobian families from ONE batched jacfwd.

    The per-block jacobians D_i = d(block_i)/d(own block) are extracted with
    a uniform seed: f(e) = batched_map(state + 1⊗e) has d f_i/d e =
    d(block_i)/d(block_i) exactly (each output block depends on no other
    block), so a single 15-tangent jacfwd over (e[6], ef[3], dq[6]) yields
    Dp/Df/Cp/Cf/Dinv while evaluating the batched primal — and its two fused
    trig sites — once, instead of one trig site per vmapped per-block jacfwd
    (the executable-mass model in CLAUDE.md is per HLO op, not per element).
    """
    z6 = jnp.zeros(6, new_poses.dtype)
    z3 = jnp.zeros(3, new_poses.dtype)

    def f(e, ef, dq):
        return G.stereo_batched(new_poses + e[None], new_feats + ef[None],
                                q + dq)

    (Dp, _, Cp), (_, Df, Cf), (_, _, Dinv) = jax.jacfwd(
        f, argnums=(0, 1, 2))(z6, z3, z6)
    return Dp, Cp, Df, Cf, Dinv


def _jacs_mono(new_poses, new_feats, q, s, fix):
    """Mono Jacobian families (J1=Dp/Df, J2=Cp/Cf, J3=C2p/C2f) from ONE
    batched 18-tangent jacfwd; see _jacs_stereo for the uniform-seed trick."""
    z6 = jnp.zeros(6, new_poses.dtype)
    z3 = jnp.zeros(3, new_poses.dtype)

    def f(e, ef, dq, ds):
        npz, nfz, _ = G.mono_batched(new_poses + e[None], new_feats + ef[None],
                                     q + dq, s + ds, fix)
        return npz, nfz

    ((Dp, _, Cp, C2p3),
     (_, Df, Cf, C2f3)) = jax.jacfwd(f, argnums=(0, 1, 2, 3))(z6, z3, z6, z3)
    return Dp, Cp, C2p3, Df, Cf, C2f3


def transform_map_stereo(lm: types.LocalMap, new_ref_id,
                         info_dtype=None) -> types.LocalMap:
    """Re-express `lm` in the frame of pose `new_ref_id` and propagate the
    information matrix (lmj_Transform_PF3DStereo, LinearSFMImp.cpp:349-1924).

    info_dtype: dtype of the congruence products (the information path). The
    state map and its autodiff Jacobians stay in the state dtype; the J^T I J
    block products — the hot ops — run in info_dtype (mixed-precision policy:
    f32 at low tree levels where cond(S) is small, see core/device_tree.py).
    """
    old_ref_id = lm.gauge.ref
    new_ids, new_poses, new_feats = G.transform_state_stereo(
        lm.pose_ids, lm.poses, lm.feats, new_ref_id, old_ref_id)

    # Old-ref slot in the new state (same slot that held new_ref; it now holds
    # the old reference pose, LinearSFMImp.cpp:416-417).
    r_slot = jnp.argmax(new_ids == old_ref_id)
    q = new_poses[r_slot]

    Dp, Cp, Df, Cf, Dinv = _jacs_stereo(new_poses, new_feats, q)
    # Ref row: x_old[r] = invpose(q); own-block derivative is d invpose/dq.
    Dp = Dp.at[r_slot].set(Dinv)
    Cp = Cp.at[r_slot].set(0.0)

    idt = jnp.dtype(info_dtype) if info_dtype is not None else lm.U.dtype
    cast = lambda x: x.astype(idt)
    em = congruence_emit(cast(lm.U), lm.Uij, cast(lm.W), lm.Wpf, cast(lm.V),
                         cast(Dp), cast(Df), cast(Cp), cast(Cf), r_slot)

    M, N = lm.M, lm.N
    U = jnp.concatenate([em["U_t"], em["newU_r"], em["rr"][None]], axis=0)
    Uij = jnp.concatenate([
        lm.Uij,
        jnp.stack([jnp.arange(M, dtype=jnp.int32),
                   jnp.full((M,), r_slot, jnp.int32)], axis=1),
        jnp.array([[0, 0]], jnp.int32) + r_slot,
    ], axis=0)
    W = jnp.concatenate([em["W_t"], em["newW_r"]], axis=0)
    Wpf = jnp.concatenate([
        lm.Wpf,
        jnp.stack([jnp.full((N,), r_slot, jnp.int32),
                   jnp.arange(N, dtype=jnp.int32)], axis=1),
    ], axis=0)

    return dataclasses.replace(
        lm, pose_ids=new_ids, poses=new_poses, feats=new_feats,
        U=U, Uij=Uij, W=W, Wpf=Wpf, V=em["V_t"],
        n_U=jnp.asarray(U.shape[0], jnp.int32),
        n_W=jnp.asarray(W.shape[0], jnp.int32),
        gauge=dataclasses.replace(lm.gauge, ref=jnp.asarray(new_ref_id, jnp.int32)),
    )


def transform_map_mono(lm: types.LocalMap, new_ref_id, new_scap_id, new_fix,
                       info_dtype=None) -> types.LocalMap:
    """Mono gauge+scale transform (lmj_Transform_PF3DMono, LinearSFMImp.cpp:3173-6509).

    info_dtype: see transform_map_stereo."""
    old = lm.gauge
    new_poses, new_feats, sign = G.transform_state_mono(
        lm.pose_ids, lm.poses, lm.feats, new_ref_id, new_scap_id, new_fix)

    # Old gauge blocks in the new state (LinearSFMImp.cpp:3311-3314).
    r_slot = jnp.argmax(lm.pose_ids == old.ref)
    s_slot = jnp.argmax(lm.pose_ids == old.scap)
    q = new_poses[r_slot]
    s = new_poses[s_slot, 0:3]

    Dp, Cp, C2p3, Df, Cf, C2f3 = _jacs_mono(new_poses, new_feats, q, s,
                                            old.fix)
    # Embed d/ds (translation-only, 3 cols) into 6-wide coupling blocks.
    C2p = jnp.concatenate([C2p3, jnp.zeros_like(C2p3)], axis=2)
    C2f = jnp.concatenate([C2f3, jnp.zeros_like(C2f3)], axis=2)

    # Folds at the gauge rows (LinearSFMImp.cpp:3495-3525, :3558-3569).
    Dp = Dp.at[r_slot].add(Cp[r_slot])
    Cp = Cp.at[r_slot].set(0.0)
    Dp = Dp.at[s_slot].add(C2p[s_slot])
    C2p = C2p.at[s_slot].set(0.0)

    # Gauge-conditioning projection (LinearSFMImp.cpp:3691-3710): zero every
    # J column belonging to a NEW gauge coordinate, so the transformed
    # information carries exactly zero rows/cols there — the new map's gauge
    # constraints (ref = 0, scap[fix] = +-1) are conditioned on, which is what
    # makes the solver's later row-deletion exact.
    p1 = jnp.argmax(lm.pose_ids == jnp.asarray(new_ref_id, jnp.int32))
    p2 = jnp.argmax(lm.pose_ids == jnp.asarray(new_scap_id, jnp.int32))
    fixv = jnp.asarray(new_fix, jnp.int32)
    Dp = Dp.at[p1].set(0.0)                                   # new ref block
    Dp = Dp.at[p2, :, :].set(
        jnp.where(jnp.arange(6)[None, :] == fixv, 0.0, Dp[p2]))  # scap fix col
    colfix = jnp.arange(6)[None, None, :] == fixv
    Cp = jnp.where(r_slot == p2, jnp.where(colfix, 0.0, Cp), Cp)
    Cf = jnp.where(r_slot == p2, jnp.where(colfix, 0.0, Cf), Cf)
    Cp = jnp.where(r_slot == p1, 0.0, Cp)
    Cf = jnp.where(r_slot == p1, 0.0, Cf)
    C2p = jnp.where(s_slot == p2, jnp.where(colfix, 0.0, C2p), C2p)
    C2f = jnp.where(s_slot == p2, jnp.where(colfix, 0.0, C2f), C2f)
    C2p = jnp.where(s_slot == p1, 0.0, C2p)                   # J3 kill (:3709)
    C2f = jnp.where(s_slot == p1, 0.0, C2f)

    idt = jnp.dtype(info_dtype) if info_dtype is not None else lm.U.dtype
    cast = lambda x: x.astype(idt)
    em = congruence_emit(cast(lm.U), lm.Uij, cast(lm.W), lm.Wpf, cast(lm.V),
                         cast(Dp), cast(Df), cast(Cp), cast(Cf),
                         r_slot, C2p=cast(C2p), C2f=cast(C2f), s_slot=s_slot)

    M, N = lm.M, lm.N
    ar = jnp.arange(M, dtype=jnp.int32)
    U = jnp.concatenate([em["U_t"], em["newU_r"], em["newU_s"],
                         em["rr"][None], em["ss"][None], em["rs"][None]], axis=0)
    Uij = jnp.concatenate([
        lm.Uij,
        jnp.stack([ar, jnp.full((M,), r_slot, jnp.int32)], axis=1),
        jnp.stack([ar, jnp.full((M,), s_slot, jnp.int32)], axis=1),
        jnp.stack([r_slot, r_slot])[None].astype(jnp.int32),
        jnp.stack([s_slot, s_slot])[None].astype(jnp.int32),
        jnp.stack([r_slot, s_slot])[None].astype(jnp.int32),
    ], axis=0)
    W = jnp.concatenate([em["W_t"], em["newW_r"], em["newW_s"]], axis=0)
    an = jnp.arange(N, dtype=jnp.int32)
    Wpf = jnp.concatenate([
        lm.Wpf,
        jnp.stack([jnp.full((N,), r_slot, jnp.int32), an], axis=1),
        jnp.stack([jnp.full((N,), s_slot, jnp.int32), an], axis=1),
    ], axis=0)

    return dataclasses.replace(
        lm, poses=new_poses, feats=new_feats,
        U=U, Uij=Uij, W=W, Wpf=Wpf, V=em["V_t"],
        n_U=jnp.asarray(U.shape[0], jnp.int32),
        n_W=jnp.asarray(W.shape[0], jnp.int32),
        gauge=dataclasses.replace(
            lm.gauge,
            ref=jnp.asarray(new_ref_id, jnp.int32),
            scap=jnp.asarray(new_scap_id, jnp.int32),
            fix=jnp.asarray(new_fix, jnp.int32),
            sign=jnp.asarray(sign, jnp.int32),
        ),
    )
