"""Multi-host hierarchical execution: host-local subtrees + replicated top.

The reference merge tree (lmj_PF3D_Divide_ConquerStereo/Mono,
/root/reference/linux/src/LinearSFMImp/LinearSFMImp.cpp:1932-2035) is a
binary reduction over the map sequence. The sequence is cut into aligned
**binary blocks** of size 2^L (the last block may be partial): inside the
first L global levels, joins never cross an aligned 2^L boundary, so each
block reduces on its owning host with zero cross-host traffic, and only the
top levels (over one root map per block) involve other hosts' data.

Arbitrary map counts are supported (NC3500 is 3,499 maps,
/root/reference/README.txt:64): a partial tail block simply reduces in fewer
levels and then rides the global schedule as the odd carry
(LinearSFMImp.cpp:1946-1948). Exactness through the carry levels needs one
extra piece of bookkeeping: the every-2nd-map re-gauge keys on the GLOBAL
output position (:1997), and a carried block root occupies position
(block_offset >> level) at each level it idles through — if any of those is
odd, the root re-gauges to the final frame exactly once (the transform is
idempotent through the ref > fref guard). Full blocks get the same positions
from the exact planner's ``map_offset`` (core/plan.py).

Cross-host policy for the top levels: ALL-GATHER the per-block roots once and run
the top levels REPLICATED on every host. A compacted root map is small (the
information form is O(map blocks), not O(trajectory²)), so a single
allgather of ceil(n/2^L) maps beats a log-depth pairwise exchange
choreography, and replication makes every host finish with bit-identical
global state — no broadcast step, no leader. Because the gathered list IS
the global level-L map list in order, the replicated top phase with
``map_offset=0`` reproduces the single-process schedule exactly.

Transport: under ``jax.distributed`` the gather runs as
``multihost_utils.process_allgather`` between hosts; single-process callers (and
the virtual-mesh dry run) pass a trivial gather. The same code path serves
both — process boundaries only change the transport, never the math.
"""

from __future__ import annotations

import numpy as np

from .. import types
from ..core import plan as plan_mod
from ..core.device_tree import DeviceTreeSolver


def plan_chunks(n_maps: int, n_hosts: int):
    """(L, block, owners): aligned binary blocks and their host assignment.

    block = 2^L with L chosen so every host owns >= 1 block when possible;
    owners[h] = (first_block, last_block+1), contiguous and near-even.
    """
    assert n_maps >= 1 and n_hosts >= 1
    per = max(1, n_maps // n_hosts)
    L = max(0, per.bit_length() - 1)
    block = 1 << L
    nblocks = -(-n_maps // block)
    base, rem = divmod(nblocks, n_hosts)
    owners = []
    lo = 0
    for h in range(n_hosts):
        take = base + (1 if h < rem else 0)
        owners.append((lo, lo + take))
        lo += take
    return L, block, owners


def _levels_of(count: int) -> int:
    """Tree levels to reduce `count` maps to one (0 for a single map)."""
    lv = 0
    while count > 1:
        count = (count + 1) // 2
        lv += 1
    return lv


def _block_spans(n_maps: int, block: int, b_lo: int, b_hi: int):
    return [(b * block, min((b + 1) * block, n_maps))
            for b in range(b_lo, b_hi)]


def _carry_regauge_positions(o: int, used: int, L: int):
    """Global output positions of a block root while it idles (carry) through
    levels used+1..L of the global schedule."""
    return [o >> l for l in range(used + 1, L + 1)]


def local_phase(maps: list[types.LocalMap], datatype: str, n_hosts: int,
                host_id: int, solver_kw: dict | None = None
                ) -> list[types.LocalMap]:
    """Reduce this host's blocks; returns the block-root maps in block order."""
    from ..core.tree import TreeSolver
    L, block, owners = plan_chunks(len(maps), n_hosts)
    b_lo, b_hi = owners[host_id]
    ts = TreeSolver(datatype)   # host-side transform for idle-carry re-gauges
    roots = []
    for (lo, hi) in _block_spans(len(maps), block, b_lo, b_hi):
        span = maps[lo:hi]
        if len(span) == 1:
            root = span[0]
            used = 0
        else:
            solver = DeviceTreeSolver(datatype, plan_offset=lo,
                                      final_regauge=False,
                                      **(solver_kw or {}))
            root = solver.run(span)
            used = _levels_of(len(span))
        if any(p % 2 == 1 for p in _carry_regauge_positions(lo, used, L)):
            # idempotent: regauge_to_final no-ops unless ref > fref, and
            # afterwards ref == fref, so one application covers every odd
            # carry position (LinearSFMImp.cpp:1997-2030 semantics).
            root = ts.regauge_to_final(root)
        roots.append(root)
    return roots


def _pad_root(lm: types.LocalMap, caps) -> types.LocalMap:
    M, N, KU, KW = caps
    return lm.pad_to(M, N, KU, KW)


def common_root_caps(maps: list[types.LocalMap], datatype: str, n_hosts: int,
                     bucket: int = 16, u_bucket: int = 64):
    """Deterministic shared capacities for every block root (incl. the
    idle-carry re-gauge growth). Each process derives this from the
    (identical) global map metadata, so the allgather exchanges equal-shaped
    buffers without a shape handshake."""
    n = len(maps)
    L, block, owners = plan_chunks(n, n_hosts)
    syms = [plan_mod.sym_of(m) for m in maps]
    caps = [1, 1, 1, 1]
    for (lo, hi) in _block_spans(n, block, 0, owners[-1][1]):
        cur = syms[lo:hi]
        off = lo
        used = 0
        while len(cur) > 1:
            assert off % 2 == 0
            off //= 2
            used += 1
            npair = len(cur) // 2
            nxt = []
            for i in range((len(cur) + 1) // 2):
                nd = (plan_mod._sym_join(cur[2 * i], cur[2 * i + 1], datatype)
                      if i < npair else cur[2 * i])
                nd, _ = plan_mod._sym_finish(nd, off + i, datatype)
                nxt.append(nd)
            cur = nxt
        root = cur[0]
        if any(p % 2 == 1
               for p in _carry_regauge_positions(lo, used, L)) \
                and root.ref > root.fref:
            root = plan_mod._sym_transform(root, root.fref, root.fscap,
                                           datatype)
        rc = plan_mod._caps([root.counts()], bucket, u_bucket)
        caps = [max(a, b) for a, b in zip(caps, rc)]
    return tuple(caps)


def local_stacked(maps: list[types.LocalMap], datatype: str, n_hosts: int,
                  host_id: int, solver_kw: dict | None = None
                  ) -> types.LocalMap:
    """This host's gather contribution: block roots padded to the common
    caps and stacked to [max_blocks_per_host, ...] (zero lanes beyond the
    owned count — peers drop them via the deterministic owner table)."""
    import jax
    _, _, owners = plan_chunks(len(maps), n_hosts)
    roots = local_phase(maps, datatype, n_hosts, host_id, solver_kw)
    caps = common_root_caps(maps, datatype, n_hosts)
    padded = [jax.tree.map(np.asarray, _pad_root(r, caps)) for r in roots]
    maxb = max(hi - lo for lo, hi in owners)
    if padded:
        dummy = jax.tree.map(np.zeros_like, padded[0])
    else:  # a host can own zero blocks when hosts > blocks
        dummy = jax.tree.map(np.zeros_like,
                             jax.tree.map(np.asarray,
                                          _pad_root(maps[0], caps)))
    padded += [dummy] * (maxb - len(padded))
    return jax.tree.map(lambda *xs: np.stack(xs), *padded)


def top_phase(roots: list[types.LocalMap], datatype: str,
              solver_kw: dict | None = None) -> types.LocalMap:
    """Replicated top levels over the gathered per-block roots (the global
    level-L map list, in order — so map_offset is 0)."""
    solver = DeviceTreeSolver(datatype, **(solver_kw or {}))
    return solver.run(roots)


def run_multihost(maps: list[types.LocalMap], datatype: str,
                  n_hosts: int | None = None, host_id: int | None = None,
                  gather=None, solver_kw: dict | None = None
                  ) -> types.LocalMap:
    """Full multi-host solve from this process's perspective.

    gather(stacked) -> list (host order) of every host's stacked
    [max_blocks, ...] block-root pytree; hosts with fewer blocks pad with
    zero lanes (the deterministic owner table tells every host how many
    lanes of each peer are real). Defaults to jax.distributed transport
    (process_allgather); pass a custom gather for tests or single-process
    simulation.
    """
    import jax
    if n_hosts is None:
        n_hosts = jax.process_count()
    if host_id is None:
        host_id = jax.process_index()
    if n_hosts == 1:
        solver = DeviceTreeSolver(datatype, **(solver_kw or {}))
        return solver.run(maps)

    L, block, owners = plan_chunks(len(maps), n_hosts)
    stacked = local_stacked(maps, datatype, n_hosts, host_id, solver_kw)

    if gather is None:
        from jax.experimental import multihost_utils

        def gather(st):
            g = multihost_utils.process_allgather(st)
            return [jax.tree.map(lambda a, h=h: a[h], g)
                    for h in range(n_hosts)]

    per_host = gather(stacked)
    all_roots = []
    for h, (lo, hi) in enumerate(owners):
        for i in range(hi - lo):
            all_roots.append(jax.tree.map(lambda a, i=i: a[i], per_host[h]))
    return top_phase(all_roots, datatype, solver_kw)
