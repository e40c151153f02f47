"""Worker process for the real two-process multi-host test (and for manual
multi-host runs): jax.distributed bootstrap + host-local subtree + cross-host
allgather + replicated top levels.

Usage: multihost_worker.py <coordinator> <num_processes> <process_id> <outdir>
           [stereo|mono]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    coord, nproc, pid, outdir = sys.argv[1:5]
    datatype = sys.argv[5] if len(sys.argv) > 5 else "stereo"
    nproc, pid = int(nproc), int(pid)

    import jax
    jax.config.update("jax_platforms", "cpu")
    from linearsfm_tpu.parallel import mesh as mesh_mod
    mesh_mod.init_multihost(coordinator_address=coord, num_processes=nproc,
                            process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()

    import numpy as np
    from synth import generate as gen
    from linearsfm_tpu.parallel import multihost as MH

    maps, _, _ = gen.make_dataset(8, datatype, noise=0.01, seed=3,
                                  covis_radius=3.0, covis_max=4)
    lms = [m.to_local_map() for m in maps]
    final = MH.run_multihost(lms, datatype,
                             solver_kw=dict(method="direct"))

    ids = np.asarray(final.pose_ids)
    poses = np.asarray(final.poses)
    keep = ids >= 0
    np.savez(os.path.join(outdir, f"result_{pid}.npz"),
             ids=ids[keep], poses=poses[keep])
    print(f"process {pid}: wrote {int(keep.sum())} poses")


if __name__ == "__main__":
    main()
