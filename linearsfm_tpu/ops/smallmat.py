"""Small-block (<=6-wide) batched matrix products WITHOUT dot_general.

Every information-path contraction in this engine is over 3- or 6-wide
block axes, so each product here is expressed as broadcast-multiply + sum —
elementwise work that is exact in f64 and cheap at these shapes (a [K,6,6]
block product is 36*K MACs, too small to tile well for a matrix unit).
The design was chosen for a machine whose f64 `dot_general` ran at ~f32
precision (the reason for ops/rotations.py's mat3_* helpers too). On the
H100 f64 `dot_general` is native, so whether this form still pays against
einsum is an open measurement (ROADMAP design item 3).

Shapes follow einsum conventions; leading batch dims broadcast.
"""

from __future__ import annotations

import jax.numpy as jnp


def bmm(a, b):
    """[..., i, k] @ [..., k, j] -> [..., i, j] via broadcast-multiply-sum."""
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def bmm_tn(a, b):
    """a^T b: [..., k, i] x [..., k, j] -> [..., i, j]."""
    return jnp.sum(a[..., :, :, None] * b[..., :, None, :], axis=-3)


def bmm_nt(a, b):
    """a b^T: [..., i, k] x [..., j, k] -> [..., i, j]."""
    return jnp.sum(a[..., :, :, None, :] * b[..., None, :, :], axis=-1)


def bmv(a, v):
    """[..., i, k] @ [..., k] -> [..., i]."""
    return jnp.sum(a * v[..., None, :], axis=-1)


def bmv_t(a, v):
    """a^T v: [..., k, i] x [..., k] -> [..., i]."""
    return jnp.sum(a * v[..., :, None], axis=-2)


def congr(d_i, blk, d_j):
    """d_i^T blk d_j for [..., a, i], [..., a, b], [..., b, j]."""
    return bmm_tn(d_i, bmm(blk, d_j))
