"""Feature-sharded Schur solve == single-device Schur solve."""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import helpers as H
from linearsfm_tpu.ops import schur, solve
from linearsfm_tpu.parallel import shard_solve


def test_sharded_schur_matches_serial():
    rng = np.random.default_rng(31)
    lm = H.random_stereo_map(rng, M=6, N=24, pose_id0=1, ref_id=0)
    U, Uij = lm.U, lm.Uij
    W, Wpf = lm.W, lm.Wpf
    V = lm.V
    poses, feats = lm.poses, lm.feats
    eP, eF = schur.info_vector(poses, feats, U, Uij, W, Wpf, V)
    M = lm.M

    # serial
    Vinv = schur.inv3x3_sym(V)
    S, E = schur.assemble_schur(U, Uij, W, Wpf, Vinv, eP, eF, M, max_obs=8)
    x = solve.solve_reduced(S, E)
    xp_ser = x.reshape(M, 6)
    xf_ser = schur.backsub_features(W, Wpf, Vinv, eF, xp_ser)

    # sharded over 4 devices
    mesh = Mesh(np.array(jax.devices()[:4]), ("fs",))
    xp_sh, xf_sh = shard_solve.sharded_schur_solve(
        U, Uij, W, Wpf, V, eP, eF, M, 8, mesh)

    np.testing.assert_allclose(np.asarray(xp_sh), np.asarray(xp_ser), atol=1e-9)
    np.testing.assert_allclose(np.asarray(xf_sh), np.asarray(xf_ser), atol=1e-9)


def test_dense_schur_path_matches_grouped():
    rng = np.random.default_rng(33)
    lm = H.random_stereo_map(rng, M=6, N=20, pose_id0=1, ref_id=0)
    eP, eF = schur.info_vector(lm.poses, lm.feats, lm.U, lm.Uij, lm.W, lm.Wpf, lm.V)
    Vinv = schur.inv3x3_sym(lm.V)
    S1, E1 = schur.assemble_schur(lm.U, lm.Uij, lm.W, lm.Wpf, Vinv, eP, eF,
                                  lm.M, max_obs=8)
    S2, E2 = schur._assemble_schur_dense(lm.U, lm.Uij, lm.W, lm.Wpf, Vinv,
                                         eP, eF, lm.M)
    np.testing.assert_allclose(np.asarray(S2), np.asarray(S1), atol=1e-9)
    np.testing.assert_allclose(np.asarray(E2), np.asarray(E1), atol=1e-9)


def test_sharded_full_mixed_solves_one_copy_of_replicated_operands():
    """On a GPU, operands that every device computes redundantly can differ
    in their last bits from device to device (scatter-adds reduce in no fixed
    order). The sharded PCG must then solve device 0's system on every
    device, not a mix of the copies: here device 1 holds a perturbed copy of
    every float operand, and the answer must equal the unperturbed solve."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    rng = np.random.default_rng(35)
    M, N = 12, 30
    U, Uij, W, Wpf, V = H.random_info_blocks(rng, M, N, obs_per_feat=4)
    eP = rng.standard_normal((M, 6))
    eF = rng.standard_normal((N, 3))
    mesh = Mesh(np.array(jax.devices()[:2]), ("fs",))
    fixed = jnp.zeros(6 * M, bool)
    ints = (jnp.asarray(Uij, jnp.int32), jnp.asarray(Wpf, jnp.int32))

    def solve_with(f):
        return shard_solve.sharded_full_mixed(
            f(U), ints[0], f(W), ints[1], f(V), f(eP), f(eF), M, fixed,
            mesh=mesh, axis="fs", iters=4)

    def skewed(x):
        rep = NamedSharding(mesh, P())
        bufs = [jax.device_put(np.asarray(x) * (1 + 1e-6 * i), dev)
                for i, dev in enumerate(mesh.devices)]
        return jax.make_array_from_single_device_arrays(x.shape, rep, bufs)

    want = solve_with(jnp.asarray)
    got = solve_with(skewed)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0,
                                   atol=1e-12)
