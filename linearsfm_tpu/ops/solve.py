"""Dense symmetric solves with gauge masking and mixed-precision refinement.

The reference factorizes the reduced camera system with CHOLMOD
(pba_solveCholmodLM/GN, /root/reference/linux/src/LinearSFMImp/LinearSFMImp.cpp:2380-2449,
:7043-7121). On an accelerator a dense Cholesky runs as large parallel
matmuls, while sparse supernodal scheduling serializes — so every join
solves a dense [6M, 6M] system; the *precision*, not the sparsity, is the
knob:

* ``direct``: factor in the working dtype (f64; native on the H100).
* ``refine``: factor in f32, then a few iterative-refinement steps
  with residuals accumulated in f64 — near-f64 accuracy at f32 speed when
  ``cond(S) * eps_f32 << 1``.

Gauge elimination (mono) masks rows/columns to identity instead of deleting
them — numerically identical to the reference's row-deleted system
(LinearSFMImp.cpp:6981-7021) and shape-static.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def mask_gauge(S, E, fixed_mask):
    """Replace fixed rows/cols by identity and zero the RHS there.

    fixed_mask: bool[d], True = coordinate is gauge-fixed (solution 0).
    """
    free = ~fixed_mask
    fo = free[:, None] & free[None, :]
    S = jnp.where(fo, S, 0.0)
    S = S + jnp.diag(jnp.where(fixed_mask, 1.0, 0.0).astype(S.dtype))
    E = jnp.where(free, E, 0.0)
    return S, E


def cholesky_solve(S, E):
    """Plain dense Cholesky solve in the input dtype."""
    L = jnp.linalg.cholesky(S)
    y = jax.scipy.linalg.solve_triangular(L, E, lower=True)
    return jax.scipy.linalg.solve_triangular(L, y, trans=1, lower=True)


def cholesky_solve_refine(S, E, iters: int = 3):
    """f32 factorization + f64 iterative refinement.

    The factorization and triangular solves run in f32; the residual
    ``r = E - S x`` is computed against the f64 operands. Each sweep multiplies
    the error by ~cond(S)*eps_f32.
    """
    S32 = S.astype(jnp.float32)
    L = jnp.linalg.cholesky(S32)

    def solve32(rhs):
        y = jax.scipy.linalg.solve_triangular(L, rhs.astype(jnp.float32), lower=True)
        return jax.scipy.linalg.solve_triangular(L, y, trans=1, lower=True)

    x = solve32(E).astype(S.dtype)

    def body(_, x):
        r = E - S @ x
        return x + solve32(r).astype(S.dtype)

    return jax.lax.fori_loop(0, iters, body, x)


def solve_reduced(S, E, fixed_mask=None, method: str = "direct", refine_iters: int = 3):
    """Solve S x = E with optional gauge masking. Returns x (zeros at fixed)."""
    if fixed_mask is not None:
        S, E = mask_gauge(S, E, fixed_mask)
    if method == "refine":
        return cholesky_solve_refine(S, E, refine_iters)
    return cholesky_solve(S, E)
