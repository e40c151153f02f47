"""Map-parallel tree levels: all pairwise joins of a level as one SPMD program.

The reference executes the joins of a level serially
(/root/reference/linux/src/LinearSFMImp/LinearSFMImp.cpp:1938-1993). Here a
whole level is a batch: stack the ⌈N/2⌉ (end, cur) pairs into leading-axis
pytrees, `shard_map` over a `pairs` mesh axis, and `vmap` the single-pair
merge on each device. This is the DP-analog axis and the main source of the
multi-chip speedup; the TP-analog (feature-sharded root solves) lives in
shard_solve.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .. import types
from ..core import join as join_mod
from ..ops import congruence


def merge_one_stereo(g: types.LocalMap, m: types.LocalMap,
                     cfg: join_mod.JoinConfig) -> types.LocalMap:
    """Transform g into m's gauge and fuse (one tree-level pair)."""
    end = congruence.transform_map_stereo(g, m.gauge.ref)
    return join_mod.join_stereo(end, m, cfg)


def merge_one_mono(g: types.LocalMap, m: types.LocalMap,
                   cfg: join_mod.JoinConfig) -> types.LocalMap:
    end = congruence.transform_map_mono(g, m.gauge.ref, m.gauge.scap, m.gauge.fix)
    return join_mod.join_mono(end, m, cfg)


def stack_maps(maps: list[types.LocalMap]) -> types.LocalMap:
    """Stack same-capacity maps along a new leading axis.

    Stacking happens host-side (numpy) so a whole level becomes ONE
    device transfer per field instead of one per map.
    """
    import numpy as np
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *maps)


def unstack_maps(batched: types.LocalMap) -> list[types.LocalMap]:
    """Split a batched map into per-map host (numpy) pytrees with one
    device_get for the whole batch."""
    host = jax.device_get(batched)
    n = host.poses.shape[0]
    return [jax.tree.map(lambda x: x[i], host) for i in range(n)]


def level_merge_fn(datatype: str, cfg: join_mod.JoinConfig, mesh: Mesh,
                   axis: str = "pairs"):
    """Build the shard_map'd batched level merge: (G, M) batched -> batched out.

    The pair batch must be divisible by the mesh axis size (pad with clones
    and drop the results host-side).
    """
    one = merge_one_stereo if datatype == "stereo" else merge_one_mono
    fn = jax.vmap(partial(one, cfg=cfg))
    spec = P(axis)
    return jax.jit(
        jax.shard_map(fn, mesh=mesh, in_specs=(spec, spec), out_specs=spec,
                      check_vma=False))


def run_level(gs: list[types.LocalMap], ms: list[types.LocalMap],
              datatype: str, cfg: join_mod.JoinConfig, mesh: Mesh,
              fn_cache: dict | None = None) -> list[types.LocalMap]:
    """Execute one tree level's joins across the mesh (host convenience)."""
    npair = len(gs)
    ndev = mesh.devices.size
    pad = (-npair) % ndev
    gs = gs + [gs[-1]] * pad
    ms = ms + [ms[-1]] * pad
    G, M = stack_maps(gs), stack_maps(ms)
    key = ("level", jax.tree.map(lambda x: x.shape, (G, M)), cfg, datatype)
    if fn_cache is not None and key in fn_cache:
        fn = fn_cache[key]
    else:
        fn = level_merge_fn(datatype, cfg, mesh)
        if fn_cache is not None:
            fn_cache[key] = fn
    out = fn(G, M)
    return unstack_maps(out)[:npair]
