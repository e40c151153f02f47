"""Mesh construction + multi-host initialization.

Topology policy (the "collective plan" for the merge tree):

* Within a host/slice, tree levels with many pairs run map-parallel over a
  ``pairs`` axis (shard_map; no cross-device traffic except the final gather).
* Root-level joins switch to the ``fs`` (feature-sharded) axis: partial
  reduced camera systems are `psum`'d across the devices.
* Across hosts, lower tree levels are host-local by construction (each host
  owns a contiguous span of local maps, exactly the reference's binary-tree
  grouping); only ⌈log2(n_hosts)⌉ upper levels move maps between hosts. The static
  schedule falls out of the map count, mirroring
  lmj_PF3D_Divide_Conquer* (LinearSFMImp.cpp:1932-2035).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> None:
    """jax.distributed bootstrap (no-op when single-process)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def pairs_mesh(n: int | None = None) -> Mesh:
    devs = jax.devices()
    n = len(devs) if n is None else min(n, len(devs))
    return Mesh(np.array(devs[:n]), ("pairs",))


def fs_mesh(n: int | None = None) -> Mesh:
    devs = jax.devices()
    n = len(devs) if n is None else min(n, len(devs))
    return Mesh(np.array(devs[:n]), ("fs",))


def auto_solver(datatype: str, use_mesh: bool = True, executor: str = "device",
                **kw):
    """The production solver wired to the available devices.

    executor="device" (default): DeviceTreeSolver with its per-level
    parallel-axis policy — shard_map'd "dp" levels over the pair axis,
    feature-sharded "tp" root levels (one mesh serves both; see
    core/device_tree.py). executor="host": the legacy host-driven TreeSolver
    with separate pairs/fs meshes.
    """
    ndev = len(jax.devices())
    if executor == "host":
        from ..core.tree import TreeSolver
        if use_mesh and ndev > 1:
            kw.setdefault("mesh", pairs_mesh())
            kw.setdefault("root_mesh", fs_mesh())
        return TreeSolver(datatype, **kw)
    from ..core.device_tree import DeviceTreeSolver
    if use_mesh and ndev > 1:
        kw.setdefault("mesh", pairs_mesh())
    return DeviceTreeSolver(datatype, **kw)
