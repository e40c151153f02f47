"""Rotation kernels: Euler (YPR) <-> rotation matrix, reference convention.

The reference parameterizes a pose as ``(t, alpha, beta, gamma)`` with
``R = Rx(gamma) @ Ry(beta) @ Rz(alpha)`` (lmj_RMatrixYPR22,
/root/reference/linux/src/LinearSFMImp/LinearSFMImp.cpp:132-143) and extracts
Euler angles with atan2 chains (lmj_InvRotMatrixYPR22 :162-177 and the
transposed variant :145-160).

All functions are written for autodiff: derivatives of `r_to_euler` through
`jax.jacfwd` reproduce the reference's hand-derived chain rules
(lmj_dRi :282-307, lmj_dRiTT :309-334) because the `/cos(beta)` factors are
kept *inside* the atan2 arguments (atan2 is scale-invariant in its gradient,
but the sign of the scaling selects the correct branch).

Everything is shape-polymorphic over leading batch dims via vmap-friendly
scalar cores.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# The reference uses PI = 3.1415926 (LinearSFMImp.h:57) for wraparound only.
REF_PI = 3.1415926


def sincos3(abg: jax.Array):
    """(sin, cos) of a [..., 3] angle triple through ONE sine op.

    Every f64 transcendental HLO op adds code to compile, almost
    independent of the tensor shape — so all six values come from a single
    stacked
    ``sin([x, x + pi/2])`` (cos x == sin(x + pi/2) to 1 ulp), instead of six
    scalar-site sin/cos calls. Autodiff adds exactly one cosine op the same
    way.
    """
    both = jnp.sin(jnp.concatenate([abg, abg + jnp.pi / 2], axis=-1))
    return both[..., 0:3], both[..., 3:6]


def euler_to_r(abg: jax.Array) -> jax.Array:
    """[..., 3] (alpha, beta, gamma) -> [..., 3, 3] rotation matrix.

    Row-major layout identical to lmj_RMatrixYPR22 (LinearSFMImp.cpp:132-143).
    """
    s, c = sincos3(abg)
    sa, sb, sg = s[..., 0], s[..., 1], s[..., 2]
    ca, cb, cg = c[..., 0], c[..., 1], c[..., 2]
    r0 = jnp.stack([cb * ca, cb * sa, -sb], axis=-1)
    r1 = jnp.stack([sg * sb * ca - cg * sa, sg * sb * sa + cg * ca, sg * cb], axis=-1)
    r2 = jnp.stack([cg * sb * ca + sg * sa, cg * sb * sa - sg * ca, cg * cb], axis=-1)
    return jnp.stack([r0, r1, r2], axis=-2)


def _euler_from_entries(r01, r00, r02, r12, r22, r10, r11):
    """Shared atan2 chain. Entry names follow (row, col) of R.

    beta  = atan2(-R[0,2], sqrt(R[0,0]^2 + R[0,1]^2))
    alpha = atan2(R[0,1], R[0,0]);  gamma = atan2(R[1,2], R[2,2])
    The reference divides the alpha/gamma arguments by cos(beta)
    (LinearSFMImp.cpp:172-175) — a no-op here: beta = atan2(-r02, +sqrt) lies
    in [-pi/2, pi/2] so cos(beta) >= 0, and atan2 is invariant under positive
    scaling of both arguments (values AND ambient derivatives agree on the
    open set cos(beta) > 0). Dropping the division removes the cos(beta)
    transcendental site and its autodiff tail entirely.

    Singular branch (cos beta == 0, tested on r00^2 + r01^2 exactly like the
    reference's fabs(cosbeta) > 1e-30 on the sqrt, :166-171): alpha = 0,
    beta = pi/2 regardless of sign (bug-compatible), gamma = atan2(r01, r11).
    All transcendentals are fused: one sqrt + two stacked atan2 ops.
    """
    cb2 = r00 * r00 + r01 * r01
    singular = cb2 < 1e-60
    cb = jnp.sqrt(jnp.where(singular, 1.0, cb2))
    one = jnp.ones_like(r00)
    ag = jnp.arctan2(
        jnp.stack([-r02, r01, r12, r01], axis=-1),
        jnp.stack([cb, jnp.where(singular, one, r00),
                   jnp.where(singular, one, r22),
                   jnp.where(singular, r11, one)], axis=-1))
    alpha = jnp.where(singular, 0.0, ag[..., 1])
    beta = jnp.where(singular, jnp.pi / 2, ag[..., 0])
    gamma = jnp.where(singular, ag[..., 3], ag[..., 2])
    return jnp.stack([alpha, beta, gamma], axis=-1)


def r_to_euler(R: jax.Array) -> jax.Array:
    """[..., 3, 3] -> [..., 3]; inverse of euler_to_r (lmj_InvRotMatrixYPR22)."""
    return _euler_from_entries(
        R[..., 0, 1], R[..., 0, 0], R[..., 0, 2],
        R[..., 1, 2], R[..., 2, 2], R[..., 1, 0], R[..., 1, 1],
    )


def r_to_euler_t(R: jax.Array) -> jax.Array:
    """Euler angles of R^T given R (lmj_InvRotMatrixYPR22T, :145-160)."""
    return r_to_euler(jnp.swapaxes(R, -1, -2))


# Tiny 3x3 products as explicit broadcast-multiply-sums. Chosen for a
# machine where dot_general with a broadcast operand (the common vmap
# in_axes=(0,None) pattern) dropped to ~f32 accuracy even at highest
# precision while elementwise arithmetic stayed true f64; on the H100 f64 is
# native, and whether einsum is faster here is open (ops/smallmat.py).

def mat3_vec(R: jax.Array, v: jax.Array) -> jax.Array:
    """[..., 3, 3] @ [..., 3] -> [..., 3]."""
    return jnp.sum(R * v[..., None, :], axis=-1)


def mat3_mul(A: jax.Array, B: jax.Array) -> jax.Array:
    """[..., 3, 3] @ [..., 3, 3]."""
    return jnp.sum(A[..., :, :, None] * B[..., None, :, :], axis=-2)


def mat3_mul_t(A: jax.Array, B: jax.Array) -> jax.Array:
    """A @ B^T for [..., 3, 3] operands."""
    return jnp.sum(A[..., :, None, :] * B[..., None, :, :], axis=-1)


def compose_rrt(R1: jax.Array, R2: jax.Array) -> jax.Array:
    """R1 @ R2^T (lmj_TimesRRT, :336-347)."""
    return mat3_mul_t(R1, R2)


def wrap_angle_pi(x: jax.Array) -> jax.Array:
    """Wrap into (-REF_PI, REF_PI] following the reference's truncation-based
    wraparound (LinearSFMImp.cpp:7433-7457): while |x| > pi subtract/add 2*pi
    computed via integer truncation of x/(2*pi)."""
    two_pi = 2.0 * REF_PI
    k = jnp.trunc(x / two_pi)
    x = x - jnp.where(x > REF_PI, (k + 1) * two_pi, jnp.where(x < -REF_PI, (k - 1) * two_pi, 0.0))
    return x


def wrap_angle_diff(x: jax.Array, ref: jax.Array) -> jax.Array:
    """Shift x by +-2*pi so that x - ref lies in [-pi, pi] (LinearSFMImp.cpp:7459-7464)."""
    d = x - ref
    return x + jnp.where(d > REF_PI, -2.0 * REF_PI, jnp.where(d < -REF_PI, 2.0 * REF_PI, 0.0))
