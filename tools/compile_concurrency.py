"""Cold AOT compile of one device tree with a given number of compile threads.

Usage:
  JAX_ENABLE_COMPILATION_CACHE=false \
      python tools/compile_concurrency.py WORKERS OUT.npz [NUM_MAPS]

Compiles every level program of the NUM_MAPS-map (default 2048) stereo loop
of bench.py's dataset (method="refine") with WORKERS concurrent compiles
(core/device_tree.COMPILE_WORKERS), prints the compile wall, solves once and
saves the poses, so that runs with different WORKERS can be compared for
time and for results. Run it with the persistent cache off, or each run
reads what the previous one compiled.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    workers, out = int(sys.argv[1]), sys.argv[2]
    num = int(sys.argv[3]) if len(sys.argv) > 3 else 2048
    import jax
    import numpy as np
    from synth import generate as gen
    from linearsfm_tpu.core import device_tree

    device_tree.COMPILE_WORKERS = workers
    maps, _, _ = gen.make_dataset(num, "stereo", noise=0.005, seed=7,
                                  covis_radius=6.0, covis_max=6)
    solver = device_tree.DeviceTreeSolver("stereo", method="refine")
    final = solver.run([m.to_local_map() for m in maps])
    jax.block_until_ready(final.poses)
    print(f"{workers} compile workers: {num}-map tree compiled in "
          f"{solver._last_timing['warm']:.2f} s on "
          f"{jax.devices()[0].device_kind}", flush=True)
    np.savez(out, ids=np.asarray(final.pose_ids),
             poses=np.asarray(final.poses))


if __name__ == "__main__":
    main()
