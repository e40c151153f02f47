"""Dense Schur assembly pieces: block-COO densification, 3x3 inverses and the
feature-chunked stripe path, against plain NumPy."""

import numpy as np
import jax.numpy as jnp
import pytest

import helpers as H  # noqa: F401
from linearsfm_tpu.ops import schur


def _dense_ref(rows, cols, vals, M, N):
    K, R, C = vals.shape
    out = np.zeros((R * M, C * N), np.float64)
    for k in range(K):
        if rows[k] >= 0:
            out[rows[k]*R:(rows[k]+1)*R, cols[k]*C:(cols[k]+1)*C] += vals[k]
    return out


@pytest.mark.parametrize("R,C,M,N,K", [(6, 3, 37, 53, 700),
                                       (6, 6, 29, 29, 500)])
def test_densify_blocks_matches_dense_ref(R, C, M, N, K):
    """Scatter-add semantics: -1 rows are skipped, duplicate (row, col)
    entries accumulate."""
    rng = np.random.default_rng(41 + C)
    rows = rng.integers(0, M, K).astype(np.int32)
    cols = rng.integers(0, N, K).astype(np.int32)
    rows[K // 2:K // 2 + K // 8] = rows[:K // 8]   # duplicate coordinates
    cols[K // 2:K // 2 + K // 8] = cols[:K // 8]
    rows[::13] = -1                                 # padding entries
    vals = rng.normal(size=(K, R, C)).astype(np.float32)
    got = schur.densify_blocks(jnp.asarray(rows), jnp.asarray(cols),
                               jnp.asarray(vals), M, N)
    assert got.shape == (R * M, C * N) and got.dtype == jnp.float32
    ref = _dense_ref(rows, cols, vals, M, N)
    err = np.abs(np.asarray(got, np.float64) - ref).max()
    assert err <= 1e-6 * np.abs(ref).max(), err


def test_inv3x3_sym_matches_numpy():
    rng = np.random.default_rng(40)
    A = rng.standard_normal((300, 3, 3))
    V = A @ np.swapaxes(A, 1, 2) + 0.5 * np.eye(3)
    V[7] = 0.0  # padded feature: the zero block maps to zero
    got = np.asarray(schur.inv3x3_sym(jnp.asarray(V)))
    ok = np.arange(300) != 7
    np.testing.assert_allclose(got[ok], np.linalg.inv(V[ok]), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_array_equal(got[7], np.zeros((3, 3)))


def test_dense_assembly_feature_chunked(monkeypatch):
    """The chunked [6M,3Nc] stripe path (large-root memory budget) equals
    the single-shot dense assembly."""
    rng = np.random.default_rng(77)
    M, N, KU, KW = 7, 23, 12, 40
    U = rng.standard_normal((KU, 6, 6)).astype(np.float32)
    Uij = np.sort(rng.integers(0, M, (KU, 2)), axis=1).astype(np.int32)
    # diagonal information blocks are symmetric in real data; the two dense
    # paths differ only in which convention they keep for asymmetric ones
    dg = Uij[:, 0] == Uij[:, 1]
    U[dg] = 0.5 * (U[dg] + np.swapaxes(U[dg], 1, 2))
    W = rng.standard_normal((KW, 6, 3)).astype(np.float32)
    Wpf = np.stack([rng.integers(0, M, KW),
                    rng.integers(0, N, KW)], axis=1).astype(np.int32)
    Vinv = rng.standard_normal((N, 3, 3)).astype(np.float32)
    eP = rng.standard_normal((M, 6)).astype(np.float32)
    eF = rng.standard_normal((N, 3)).astype(np.float32)

    args = (jnp.asarray(U), jnp.asarray(Uij), jnp.asarray(W),
            jnp.asarray(Wpf), jnp.asarray(Vinv), jnp.asarray(eP),
            jnp.asarray(eF), M)
    S0, E0 = schur._assemble_schur_dense(*args)
    monkeypatch.setattr(schur, "_dense_w_bytes",
                        lambda: 6 * M * 3 * 8 * 4)  # ~3 chunks
    S1, E1 = schur._assemble_schur_dense(*args)
    np.testing.assert_allclose(np.asarray(S1), np.asarray(S0), atol=1e-3)
    np.testing.assert_allclose(np.asarray(E1), np.asarray(E0), atol=1e-4)
