"""Microbenchmark of join-internal pieces at a tree-level shape.

Answers: where do the seconds go inside one batched level program —
batched f64 Cholesky, triangular solves, dense-S scatter assembly,
feature grouping, or the congruence transform.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

B = int(sys.argv[1]) if len(sys.argv) > 1 else 256      # batch (pairs)
M = int(sys.argv[2]) if len(sys.argv) > 2 else 32       # joint pose capacity
N = int(sys.argv[3]) if len(sys.argv) > 3 else 32       # joint feat capacity
KU = int(sys.argv[4]) if len(sys.argv) > 4 else 128
KW = int(sys.argv[5]) if len(sys.argv) > 5 else 128
O = int(sys.argv[6]) if len(sys.argv) > 6 else 4


def bench(name, fn, *args, n=3):
    """Times fn by device_get of a scalar reduction of its outputs, which
    forces every output to materialize (one host round trip per call, the
    floor to compare against)."""
    import jax
    import jax.numpy as jnp
    g = jax.jit(lambda *a: jax.tree.map(
        lambda x: jnp.sum(jnp.abs(x.astype(jnp.float32))), fn(*a)))
    r = g(*args)
    jax.device_get(jax.tree.leaves(r)[0])
    ts = []
    for _ in range(n):
        t0 = time.time()
        r = g(*args)
        jax.device_get(jax.tree.leaves(r)[0])
        ts.append(time.time() - t0)
    print(f"{name:38s} {min(ts)*1000:9.1f} ms", flush=True)


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np
    import linearsfm_tpu  # noqa: F401  (x64 + cache config)
    from linearsfm_tpu.ops import schur

    rng = np.random.default_rng(0)
    D = 6 * M
    A = rng.normal(size=(B, D, D))
    S64 = jnp.asarray(np.einsum("bij,bkj->bik", A, A) + 10 * np.eye(D))
    E64 = jnp.asarray(rng.normal(size=(B, D)))

    print(f"B={B} M={M} N={N} KU={KU} KW={KW} O={O}  (D={D})", flush=True)

    bench("cholesky f64", lambda S: jnp.linalg.cholesky(S), S64)
    bench("cholesky f32", lambda S: jnp.linalg.cholesky(S.astype(jnp.float32)), S64)
    bench("cho+2tri f64",
          lambda S, E: jax.scipy.linalg.cho_solve(
              (jnp.linalg.cholesky(S), True), E[..., None]), S64, E64)
    bench("cho+2tri f32",
          lambda S, E: jax.scipy.linalg.cho_solve(
              (jnp.linalg.cholesky(S.astype(jnp.float32)), True),
              E.astype(jnp.float32)[..., None]), S64, E64)

    U = jnp.asarray(rng.normal(size=(B, KU, 6, 6)))
    ui = jnp.asarray(rng.integers(0, M, (B, KU)))
    uj = jnp.asarray(rng.integers(0, M, (B, KU)))

    def scatter_S(U, ui, uj):
        def one(U, ui, uj):
            S = jnp.zeros((M, 6, M, 6), U.dtype)
            return S.at[ui, :, uj, :].add(U)
        return jax.vmap(one)(U, ui, uj)

    bench("S scatter-add f64", scatter_S, U, ui, uj)
    bench("S scatter-add f32",
          lambda U, ui, uj: scatter_S(U.astype(jnp.float32), ui, uj), U, ui, uj)

    def onehot_S(U, ui, uj):
        def one(U, ui, uj):
            oi = jax.nn.one_hot(ui, M, dtype=U.dtype)          # [KU, M]
            oj = jax.nn.one_hot(uj, M, dtype=U.dtype)
            T = jnp.einsum("kij,kb->ikbj", U, oj).reshape(6, KU, 6 * M)
            return jnp.einsum("ka,ikx->aix", oi, T).reshape(M, 6, M, 6)
        return jax.vmap(one)(U, ui, uj)

    bench("S one-hot einsum f64", onehot_S, U, ui, uj)
    bench("S one-hot einsum f32",
          lambda U, ui, uj: onehot_S(U.astype(jnp.float32), ui, uj), U, ui, uj)

    W = jnp.asarray(rng.normal(size=(B, KW, 6, 3)))
    Wpf = jnp.stack([jnp.asarray(rng.integers(0, M, (B, KW))),
                     jnp.asarray(rng.integers(0, N, (B, KW)))], axis=-1)
    Vi = jnp.asarray(rng.normal(size=(B, N, 3, 3)))

    def grouped(W, Wpf, Vi):
        def one(W, Wpf, Vi):
            entry, valid, _ = schur.group_by_feature(Wpf, N, O)
            Wg = W[entry] * valid[..., None, None]
            Yc = jnp.einsum("nofk,nkl->nofl", Wg, Vi)
            return jnp.einsum("nofk,npgk->nopfg", Yc, Wg)
        return jax.vmap(one)(W, Wpf, Vi)

    bench("group_by_feature+pairprod f64", grouped, W, Wpf, Vi)

    def seg(W, Wpf):
        def one(W, Wpf):
            return jax.ops.segment_sum(
                jnp.einsum("kif,kf->ki", W, jnp.ones((KW, 3), W.dtype)),
                Wpf[:, 0], M)
        return jax.vmap(one)(W, Wpf)

    bench("segment_sum eP f64", seg, W, Wpf)

    def argsorts(Wpf):
        def one(Wpf):
            return jnp.argsort(Wpf[:, 1], stable=True)
        return jax.vmap(one)(Wpf)

    bench("argsort [KW] x B", argsorts, Wpf)

    # congruence-transform analog: batched tiny jacobian products
    J = jnp.asarray(rng.normal(size=(B, KU, 6, 6)))
    bench("congruence einsum f64",
          lambda J, U: jnp.einsum("kab,kbc,kdc->kad", J, U, J),
          J.reshape(B * KU, 6, 6), U.reshape(B * KU, 6, 6))


if __name__ == "__main__":
    main()
