"""Gauge (coordinate/scale) transforms of local maps — the per-block maps.

The reference implements these as ~4,900 hand-unrolled lines
(`lmj_Transform_PF3DStereo`, /root/reference/linux/src/LinearSFMImp/LinearSFMImp.cpp:349-1924;
`lmj_Transform_PF3DMono`, :3173-6509). This design expresses a
transform as a tiny per-block function of (own block, gauge parameters) and
gets every Jacobian by `jax.jacfwd` — the reference's hand-derived J1/J2/J3
are exactly these derivatives (see tests/test_congruence.py).

Semantics (verified against the reference):

* Stereo (gauge = 6-DOF pose `g` of the new reference pose `Ref`):
  pose ``(tb, Rb) -> (R (tb - t), Rb R^T)``; feature ``f -> R (f - t)``
  (state loop :421-455). The slot holding `Ref` is *reused* for the old
  reference, with value ``invpose(g) = (-R t, euler(R^T))`` and tag swapped to
  ``-oldRef`` (:416-417, :427-431).

* Mono (gauge = pose `Ref` + scale pose `ScaP` + pinned axis `Fix`):
  ``scale = |[R (t_scap - t)]_fix|``; every translation / feature divided by
  `scale` after the stereo-style transform (:3268-3306). The new Ref block
  lands at exactly 0 and ScaP's pinned coordinate at ``sign = +-1`` — both are
  the generic formula evaluated exactly, which the reference writes explicitly
  (:3282-3294); we do the same to avoid round-off.

The transforms are involutions: applying the transform with the *old* gauge
tags to the transformed state returns the original state. The information
congruence ``I' = J^T I J`` therefore uses ``J = d(old state)/d(new state)`` =
the Jacobian of the *same formula*, evaluated at the new state with the old
gauge parameters (the reference builds J at :459-683 from `ptr2`, i.e. the
transformed state).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .rotations import (euler_to_r, mat3_mul_t, mat3_vec,
                        r_to_euler, r_to_euler_t)


# --------------------------------------------------------------------------
# Per-block maps. All take the gauge pose g = (t[3], abg[3]).
# --------------------------------------------------------------------------

def invpose(g: jax.Array) -> jax.Array:
    """Pose of the old frame origin expressed in g's frame: (-R t, euler(R^T)).

    Reference: LinearSFMImp.cpp:427-431.
    """
    t, R = g[0:3], euler_to_r(g[3:6])
    return jnp.concatenate([-mat3_vec(R, t), r_to_euler_t(R)])


def stereo_pose_block(x: jax.Array, g: jax.Array) -> jax.Array:
    """Generic pose re-expression in g's frame (LinearSFMImp.cpp:435-442)."""
    t, R = g[0:3], euler_to_r(g[3:6])
    tp = mat3_vec(R, x[0:3] - t)
    ang = r_to_euler(mat3_mul_t(euler_to_r(x[3:6]), R))
    return jnp.concatenate([tp, ang])


def stereo_feat_block(x: jax.Array, g: jax.Array) -> jax.Array:
    """Feature re-expression (LinearSFMImp.cpp:449-451)."""
    t, R = g[0:3], euler_to_r(g[3:6])
    return mat3_vec(R, x - t)


def mono_scale(g: jax.Array, s: jax.Array, fix: jax.Array):
    """(scale, sign) from gauge pose g and scale-pose translation s.

    ``ts = R (s - t); scale = |ts[fix]|; sign = sgn0(ts[fix])`` with
    sign(0) := +1 (LinearSFMImp.cpp:3235-3244).
    """
    t, R = g[0:3], euler_to_r(g[3:6])
    ts = mat3_vec(R, s - t)
    tsf = jnp.take(ts, fix)
    sign = jnp.where(tsf >= 0, 1.0, -1.0)
    return tsf * sign, sign


def mono_pose_block(x: jax.Array, g: jax.Array, s: jax.Array, fix: jax.Array) -> jax.Array:
    """Mono pose re-expression incl. scale normalisation (LinearSFMImp.cpp:3273-3280)."""
    t, R = g[0:3], euler_to_r(g[3:6])
    scale, _ = mono_scale(g, s, fix)
    tp = mat3_vec(R, x[0:3] - t) / scale
    ang = r_to_euler(mat3_mul_t(euler_to_r(x[3:6]), R))
    return jnp.concatenate([tp, ang])


def mono_feat_block(x: jax.Array, g: jax.Array, s: jax.Array, fix: jax.Array) -> jax.Array:
    t, R = g[0:3], euler_to_r(g[3:6])
    scale, _ = mono_scale(g, s, fix)
    return mat3_vec(R, x - t) / scale


# --------------------------------------------------------------------------
# Batched whole-map gauge maps. Semantically identical to vmapping the
# per-block functions above, but all trig is funneled through ONE stacked
# sincos site and ONE fused euler-extraction site: the per-block form (one
# trig site per vmap callee per argument) multiplied the f64 transcendental
# HLO ops of every level program (186 vs 14 sites), and with them the code
# to compile.
# --------------------------------------------------------------------------

def stereo_batched(poses, feats, g):
    """All per-block stereo maps + the invpose lane in one batched call.

    Returns (new_poses[M,6] — generic formula at every slot, NOT yet
    ref-slot-patched; new_feats[N,3]; inv[6] = invpose(g)).
    """
    t = g[0:3]
    angs = jnp.concatenate([poses[:, 3:6], g[None, 3:6]], axis=0)
    Rall = euler_to_r(angs)                      # ONE fused sincos site
    Rx, Rg = Rall[:-1], Rall[-1]
    tp = mat3_vec(Rg[None], poses[:, 0:3] - t)
    prods = mat3_mul_t(Rx, Rg[None])             # R_i R^T per slot
    stack = jnp.concatenate([prods, jnp.swapaxes(Rg, -1, -2)[None]], axis=0)
    eulers = r_to_euler(stack)                   # ONE fused extraction site
    new_poses = jnp.concatenate([tp, eulers[:-1]], axis=1)
    inv = jnp.concatenate([-mat3_vec(Rg, t), eulers[-1]])
    new_feats = mat3_vec(Rg[None], feats - t)
    return new_poses, new_feats, inv


def mono_batched(poses, feats, g, s, fix):
    """All per-block mono maps in one batched call (no invpose lane: the mono
    reference pose is an explicit block). Returns (new_poses — generic
    formula, not yet gauge-pinned; new_feats; sign)."""
    t = g[0:3]
    angs = jnp.concatenate([poses[:, 3:6], g[None, 3:6]], axis=0)
    Rall = euler_to_r(angs)
    Rx, Rg = Rall[:-1], Rall[-1]
    ts = mat3_vec(Rg, s - t)
    tsf = jnp.take(ts, fix)
    sign = jnp.where(tsf >= 0, 1.0, -1.0)
    scale = tsf * sign
    tp = mat3_vec(Rg[None], poses[:, 0:3] - t) / scale
    eulers = r_to_euler(mat3_mul_t(Rx, Rg[None]))
    new_poses = jnp.concatenate([tp, eulers], axis=1)
    new_feats = mat3_vec(Rg[None], feats - t) / scale
    return new_poses, new_feats, sign


# --------------------------------------------------------------------------
# Whole-state transforms (values only; Jacobians live in congruence.py).
# --------------------------------------------------------------------------

def transform_state_stereo(pose_ids, poses, feats, new_ref_id, old_ref_id):
    """Re-express all pose/feature slots in the frame of pose `new_ref_id`.

    Returns (pose_ids', poses', feats'). The slot of `new_ref_id` is re-tagged
    to `old_ref_id` and holds invpose(g) (LinearSFMImp.cpp:389-455).
    """
    pose_ids = jnp.asarray(pose_ids)  # may be host/numpy-backed un-jitted
    poses = jnp.asarray(poses)
    feats = jnp.asarray(feats)
    slot = jnp.argmax(pose_ids == new_ref_id)
    g = poses[slot]
    new_poses, new_feats, inv = stereo_batched(poses, feats, g)
    new_poses = new_poses.at[slot].set(inv)
    new_ids = pose_ids.at[slot].set(old_ref_id)
    return new_ids, new_poses, new_feats


def transform_state_mono(pose_ids, poses, feats, new_ref_id, new_scap_id, new_fix):
    """Mono re-expression; returns (poses', feats', sign). Pose ids unchanged
    (every pose incl. the reference is an explicit block in mono)."""
    pose_ids = jnp.asarray(pose_ids)
    poses = jnp.asarray(poses)
    feats = jnp.asarray(feats)
    slot_r = jnp.argmax(pose_ids == new_ref_id)
    slot_s = jnp.argmax(pose_ids == new_scap_id)
    g = poses[slot_r]
    s = poses[slot_s, 0:3]
    new_poses, new_feats, sign = mono_batched(poses, feats, g, s, new_fix)
    # Exact gauge pinning (LinearSFMImp.cpp:3282-3294).
    new_poses = new_poses.at[slot_r].set(jnp.zeros(6, poses.dtype))
    new_poses = new_poses.at[slot_s, :].set(
        jnp.where(jnp.arange(6) == new_fix, sign, new_poses[slot_s, :])
    )
    return new_poses, new_feats, sign
