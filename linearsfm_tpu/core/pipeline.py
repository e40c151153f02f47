"""Top-level pipeline: load local maps, run the merge tree, save results.

Mirrors runStereo/runMono
(/root/reference/linux/src/LinearSFMImp/LinearSFMImp.cpp:97-112, :3136-3152).
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np

from .. import types
from ..io import localmap as lio
from .tree import TreeSolver

log = logging.getLogger("linearsfm_tpu")


def load_local_maps(path: str, num: int, datatype: str) -> list[types.LocalMap]:
    """Load `localmap_1.txt` .. `localmap_<num>.txt` (lmj_loadLocalMaps*)."""
    return [lio.read_local_map(os.path.join(path, f"localmap_{i + 1}.txt"), datatype)
            for i in range(num)]


def run(path: str, num: int, datatype: str,
        st_path: str | None = None, pose_path: str | None = None,
        feat_path: str | None = None, method: str = "direct",
        progress: bool = True, solver: TreeSolver | None = None,
        ckpt_dir: str | None = None, resume: bool = False,
        trace_dir: str | None = None, metrics=None,
        executor: str = "host"):
    """Full run; returns (final LocalMap, wall_seconds).

    executor: "host" = host-driven scheduler (core/tree.py, supports
    checkpoint/resume and per-level compaction stats); "device" =
    device-resident block-list tree (core/device_tree.py) — the production
    default (the CLI's) and the only fast path with checkpoint/resume;
    "dense" = host-planned dense executor (core/dense_tree.py) — an
    experiment kept for study (see ARCHITECTURE.md).
    trace_dir enables a jax.profiler trace of the solve.
    """
    maps = load_local_maps(path, num, datatype)
    if solver is None:
        if executor == "dense":
            from .dense_tree import DenseTreeSolver
            solver = DenseTreeSolver(datatype, method=method, progress=progress)
        elif executor == "device":
            from .device_tree import DeviceTreeSolver
            solver = DeviceTreeSolver(datatype, method=method, progress=progress)
        else:
            solver = TreeSolver(datatype, method=method, progress=progress)
    import jax
    from .device_tree import DeviceTreeSolver
    t0 = time.time()
    kw = dict(metrics=metrics)
    if isinstance(solver, (TreeSolver, DeviceTreeSolver)):
        kw.update(ckpt_dir=ckpt_dir, resume=resume)
    elif ckpt_dir or resume:
        log.warning("checkpoint/resume requires the host or device executor; "
                    "ignoring")
    if trace_dir:
        with jax.profiler.trace(trace_dir):
            final = solver.run(maps, **kw)
    else:
        final = solver.run(maps, **kw)
    wall = time.time() - t0
    log.info("Total Used Time:  %f  sec", wall)

    ids = np.asarray(final.pose_ids)
    poses = np.asarray(final.poses)
    fids = np.asarray(final.feat_ids)
    feats = np.asarray(final.feats)
    pv, fv = ids >= 0, fids >= 0
    if st_path:
        lio.write_state(st_path, ids[pv], poses[pv], fids[fv], feats[fv])
    if pose_path:
        lio.write_poses(pose_path, ids[pv], poses[pv])
    if feat_path:
        lio.write_features(feat_path, fids[fv], feats[fv])
    return final, wall
