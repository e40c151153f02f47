"""Split one device-tree level's wall into transform / join+solve / compact.

Usage: python tools/profile_level_parts.py [NUM_MAPS] [LEVEL] [stereo|mono]

Runs the real tree up to LEVEL-1, then times three vmapped programs on that
level's actual input: (T) gauge transform only, (TJ) transform + join/solve,
(full) the production level program (adds re-gauge + device compaction).
Differences attribute the wall to each stage.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

NUM = int(sys.argv[1]) if len(sys.argv) > 1 else 512
LEVEL = int(sys.argv[2]) if len(sys.argv) > 2 else 8
TYP = sys.argv[3] if len(sys.argv) > 3 else "stereo"


def main():
    import jax
    from synth import generate as gen
    from linearsfm_tpu.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu.core import compact as compact_mod, plan as plan_mod

    maps, _, _ = gen.make_dataset(NUM, TYP, noise=0.005, seed=7)
    lms = [m.to_local_map() for m in maps]
    solver = DeviceTreeSolver(TYP, method="refine")
    stacked = compact_mod.compact_stack(lms, solver.bucket, solver.u_bucket)
    syms = plan_mod.sym_of_stacked(stacked)
    plans = plan_mod.plan_tree_exact(syms, TYP, solver.bucket,
                                     solver.u_bucket).levels
    caps = plans[0].caps_in
    import numpy as np
    import dataclasses as dc

    def grow(a, cap, fill=0):
        if a.ndim < 2 or a.shape[1] >= cap:
            return a
        return np.pad(a, [(0, 0), (0, cap - a.shape[1])]
                      + [(0, 0)] * (a.ndim - 2), constant_values=fill)

    Mi, Ni, KUi, KWi = caps
    stacked = dc.replace(
        stacked, pose_ids=grow(stacked.pose_ids, Mi, -1),
        poses=grow(stacked.poses, Mi),
        feat_ids=grow(stacked.feat_ids, Ni, -1), feats=grow(stacked.feats, Ni),
        U=grow(stacked.U, KUi), Uij=grow(stacked.Uij, KUi),
        W=grow(stacked.W, KWi), Wpf=grow(stacked.Wpf, KWi),
        V=grow(stacked.V, Ni))
    x = jax.device_put(stacked)
    for lp in plans[: LEVEL - 1]:
        x, _ = solver._level_program(lp)(x)
    jax.block_until_ready(x.poses)
    lp = plans[LEVEL - 1]
    print(f"L{LEVEL}: count={lp.count} in={lp.caps_in} out={lp.caps_out}",
          flush=True)

    from linearsfm_tpu.ops import congruence
    from linearsfm_tpu.core import join as join_mod

    cfg = solver._cfg(2 * lp.caps_in[0])
    npair = lp.count // 2

    def split(z):
        G = jax.tree.map(lambda a: a[0:2 * npair:2], z)
        Mb = jax.tree.map(lambda a: a[1:2 * npair:2], z)
        return G, Mb

    if TYP == "stereo":
        tf = lambda g, m: congruence.transform_map_stereo(
            g, m.gauge.ref, info_dtype=cfg.info_dtype)
    else:
        tf = lambda g, m: congruence.transform_map_mono(
            g, m.gauge.ref, m.gauge.scap, m.gauge.fix,
            info_dtype=cfg.info_dtype)

    @jax.jit
    def prog_T(z):
        G, Mb = split(z)
        return jax.vmap(tf)(G, Mb)

    @jax.jit
    def prog_TJ(z):
        G, Mb = split(z)
        return jax.vmap(lambda g, m: solver._merge_one(g, m, cfg))(G, Mb)[0]

    progs = [("T   (transform)", prog_T, "poses"),
             ("TJ  (transform+join/solve)", prog_TJ, "poses"),
             ("full (level program)",
              lambda z: solver._level_program(lp)(z)[0], "poses")]
    # The level program donates its input, so every call gets a fresh
    # device copy of the level input, put there before the timer starts.
    xh = jax.device_get(x)
    for name, p, fld in progs:
        jax.block_until_ready(getattr(p(jax.device_put(xh)), fld))  # warm
        walls = []
        for _ in range(3):
            xd = jax.block_until_ready(jax.device_put(xh))
            t = time.time()
            jax.block_until_ready(getattr(p(xd), fld))
            walls.append(time.time() - t)
        print(f"{name:30s} {min(walls)*1e3:8.1f} ms", flush=True)


if __name__ == "__main__":
    main()
