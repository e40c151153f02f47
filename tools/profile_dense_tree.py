"""Wall-clock of the dense planned executor (core/dense_tree.py) on the device.

Usage: python tools/profile_dense_tree.py [NUM_MAPS] [stereo|mono] [method]
Prints cold/warm walls + the plan/densify/levels/get split, then per-level
dispatch walls.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

NUM = int(sys.argv[1]) if len(sys.argv) > 1 else 512
TYP = sys.argv[2] if len(sys.argv) > 2 else "stereo"
METHOD = sys.argv[3] if len(sys.argv) > 3 else "refine"


def main():
    import jax
    from synth import generate as gen
    from linearsfm_tpu.core.dense_tree import DenseTreeSolver

    t0 = time.time()
    maps, _, _ = gen.make_dataset(NUM, TYP, noise=0.005, seed=7)
    lms = [m.to_local_map() for m in maps]
    print(f"[{time.time()-t0:7.2f}s] dataset ready ({NUM} {TYP})", flush=True)

    solver = DenseTreeSolver(TYP, method=METHOD)
    for label in ("cold", "warm", "warm2"):
        t1 = time.time()
        out = solver.run(lms)
        w = time.time() - t1
        print(f"{label}: {w:7.2f}s ({(NUM-1)/w:7.1f} maps/s) "
              f"timing={solver._last_timing}", flush=True)

    # per-level dispatch walls (warm cache; device_get fences each level)
    import numpy as np
    import jax
    from linearsfm_tpu.core import compact as compact_mod, layout as L

    cm = [compact_mod.compact(jax.device_get(lm), 1, 1) for lm in lms]
    plan = L.plan_dense_tree([L.layout_of(lm) for lm in cm], TYP,
                             solver.bucket)
    from linearsfm_tpu.core import dense_tree as dt
    Mi, Ni = plan.levels[0].caps_in
    B = len(cm)
    poses = np.zeros((B, Mi, 6)); feats = np.zeros((B, Ni, 3))
    A = np.zeros((B, Mi, 6, Mi, 6)); Wd = np.zeros((B, Mi, Ni, 6, 3))
    V = np.zeros((B, Ni, 3, 3)); sign = np.ones((B,))
    for bi, lm in enumerate(cm):
        m, n = int(lm.n_poses), int(lm.n_feats)
        poses[bi, :m] = np.asarray(lm.poses)[:m]
        feats[bi, :n] = np.asarray(lm.feats)[:n]
        A[bi], Wd[bi], V[bi] = dt.densify(lm, Mi, Ni)
        sign[bi] = float(lm.gauge.sign)
    from linearsfm_tpu.ops import dense as Dops
    import jax.numpy as jnp
    idt0, _ = solver._policy(2 * plan.levels[0].caps_in[0])
    x = Dops.DenseMap(jnp.asarray(poses), jnp.asarray(feats),
                      jnp.asarray(A, jnp.dtype(idt0)),
                      jnp.asarray(Wd, jnp.dtype(idt0)),
                      jnp.asarray(V, jnp.dtype(idt0)), jnp.asarray(sign))
    jax.device_get(x.sign)
    for li, lp in enumerate(plan.levels):
        b = dict(lp.bundle)
        b["rg_slots"] = (lp.rg_bundle["slots"] if lp.rg_bundle is not None
                         else np.zeros((0, 1), np.int32))
        t1 = time.time()
        x = solver._level_program(lp)(x, b)
        jax.device_get(x.sign)
        idt, meth = solver._policy(2 * lp.caps_in[0])
        print(f"L{li+1:2d} count={lp.count:4d} in={lp.caps_in} "
              f"out={lp.caps_out} {idt}/{meth} wall={time.time()-t1:7.3f}s",
              flush=True)


if __name__ == "__main__":
    main()
