"""Hierarchical divide-and-conquer merge scheduler.

Reference: lmj_PF3D_Divide_ConquerStereo
(/root/reference/linux/src/LinearSFMImp/LinearSFMImp.cpp:1926-2099) and the
mono variant (:6511-6658). Binary-tree reduction with odd-count carry, a
re-gauge to the final reference after every 2nd generated map per level and
once at the end.

The host drives the tree; each transform/join runs as a jitted program cached
by shape signature (maps are compacted and bucketed between levels so one
compilation serves a whole level). Level parallelism over a device mesh lives
in parallel/ (shard_map over the pair axis).
"""

from __future__ import annotations

import logging
import time
from functools import partial

import jax
import numpy as np

from .. import types
from ..ops import congruence
from . import compact as compact_mod
from . import join as join_mod

log = logging.getLogger("linearsfm_tpu")


def _max_obs_per_feature(lm: types.LocalMap) -> int:
    Wpf = np.asarray(lm.Wpf)
    nz = np.any(np.asarray(lm.W) != 0, axis=(1, 2))
    f = Wpf[nz, 1]
    if f.size == 0:
        return 1
    return int(np.bincount(f).max())


class TreeSolver:
    """Runs the merge tree for one data type ("stereo" | "mono").

    strategy:
      * "level" (default): all joins of a tree level run as ONE jitted
        vmapped program (optionally shard_map'd over a mesh): a single
        device dispatch per level instead of per join.
      * "serial": one jitted program per join, reference-like host loop.
    """

    def __init__(self, datatype: str, method: str = "direct",
                 refine_iters: int = 3, bucket: int = 16, u_bucket: int = 64,
                 progress: bool = False, strategy: str = "level", mesh=None,
                 pin: str = "sign", root_mesh=None, root_shard_min: int = 256):
        assert datatype in ("stereo", "mono")
        self.datatype = datatype
        self.method = method
        self.refine_iters = refine_iters
        self.bucket = bucket
        self.u_bucket = u_bucket
        self.progress = progress
        self.strategy = strategy
        self.mesh = mesh
        self.pin = pin
        # Feature-sharded Schur for big single-pair (root) joins: TP-analog.
        self.root_mesh = root_mesh
        self.root_shard_min = root_shard_min
        self._jit_cache: dict = {}
        self.join_count = 0

    # -- jitted kernels, cached by static signature -------------------------
    def _sig(self, *lms: types.LocalMap):
        return tuple((lm.M, lm.N, lm.KU, lm.KW) for lm in lms)

    def _transform(self, lm: types.LocalMap, gauge: types.Gauge) -> types.LocalMap:
        key = ("t", self._sig(lm))
        if key not in self._jit_cache:
            if self.datatype == "stereo":
                self._jit_cache[key] = jax.jit(congruence.transform_map_stereo)
            else:
                self._jit_cache[key] = jax.jit(congruence.transform_map_mono)
        fn = self._jit_cache[key]
        if self.datatype == "stereo":
            return fn(lm, gauge.ref)
        return fn(lm, gauge.ref, gauge.scap, gauge.fix)

    def _join(self, end: types.LocalMap, cur: types.LocalMap, max_obs: int,
              mesh=None) -> types.LocalMap:
        cfg = join_mod.JoinConfig(max_obs=max_obs, method=self.method,
                                  refine_iters=self.refine_iters, pin=self.pin,
                                  mesh=mesh)
        key = ("j", self._sig(end, cur), cfg)
        if key not in self._jit_cache:
            f = join_mod.join_stereo if self.datatype == "stereo" else join_mod.join_mono
            self._jit_cache[key] = jax.jit(partial(f, cfg=cfg))
        return self._jit_cache[key](end, cur)

    # -- merge steps ---------------------------------------------------------
    def merge_pair(self, g: types.LocalMap, m: types.LocalMap) -> types.LocalMap:
        """Transform accumulated map `g` into `m`'s gauge and fuse."""
        if int(g.gauge.ref) != int(m.gauge.ref) or (
                self.datatype == "mono" and int(g.gauge.scap) != int(m.gauge.scap)):
            g = self._transform(g, m.gauge)
        # a shared max_obs for the fused map (upper bound: sum of both sides)
        mo = types.bucket(_max_obs_per_feature(g) + _max_obs_per_feature(m), 4)
        mesh = (self.root_mesh
                if self.root_mesh is not None
                and g.M + m.M >= self.root_shard_min else None)
        out = self._join(g, m, mo, mesh=mesh)
        self.join_count += 1
        return out

    def regauge_to_final(self, g: types.LocalMap) -> types.LocalMap:
        """Re-express in the first map's gauge if needed (:1997-2030)."""
        if int(g.gauge.ref) > int(g.gauge.fref):
            fin = types.Gauge(
                ref=g.gauge.fref, scap=g.gauge.fscap, fix=g.gauge.ffix,
                sign=g.gauge.sign, fref=g.gauge.fref, fscap=g.gauge.fscap,
                ffix=g.gauge.ffix)
            g = self._transform(g, fin)
        return g

    # -- level-batched execution ---------------------------------------------
    def _common_capacity(self, maps: list[types.LocalMap]):
        M = max(lm.M for lm in maps)
        N = max(lm.N for lm in maps)
        KU = max(lm.KU for lm in maps)
        KW = max(lm.KW for lm in maps)
        return M, N, KU, KW

    def _level_fn(self, sig, max_obs: int):
        from ..parallel import level as plevel
        cfg = join_mod.JoinConfig(max_obs=max_obs, method=self.method,
                                  refine_iters=self.refine_iters, pin=self.pin)
        key = ("lvl", sig, cfg)
        if key not in self._jit_cache:
            one = (plevel.merge_one_stereo if self.datatype == "stereo"
                   else plevel.merge_one_mono)
            fn = jax.vmap(lambda g, m: one(g, m, cfg))
            if self.mesh is not None:
                from jax.sharding import PartitionSpec as P
                spec = P(self.mesh.axis_names[0])
                fn = jax.shard_map(fn, mesh=self.mesh, in_specs=(spec, spec),
                                   out_specs=spec, check_vma=False)
            self._jit_cache[key] = jax.jit(fn)
        return self._jit_cache[key]

    def _run_level_batched(self, gs, ms):
        """All pairwise joins of one level as a single program."""
        from ..parallel import level as plevel
        t0 = time.time()
        both = gs + ms
        M, N, KU, KW = self._common_capacity(both)
        both = [lm.pad_to(M, N, KU, KW) for lm in both]
        gs, ms = both[:len(gs)], both[len(gs):]
        # +1/+2: merge_one transforms g IN-program, which emits one (r,f)
        # coupling per feature (mono also (s,f)) on top of g's own entries.
        span = 1 if self.datatype == "stereo" else 2
        mo = types.bucket(max(_max_obs_per_feature(g) for g in gs) + span +
                          max(_max_obs_per_feature(m) for m in ms), 4)
        npair = len(gs)
        ndev = 1 if self.mesh is None else int(self.mesh.devices.size)
        pad = (-npair) % ndev
        gs = gs + [gs[-1]] * pad
        ms = ms + [ms[-1]] * pad
        G = plevel.stack_maps(gs)
        Mb = plevel.stack_maps(ms)
        sig = jax.tree.map(lambda x: x.shape, (G, Mb))
        t1 = time.time()
        out = self._level_fn(sig, mo)(G, Mb)
        jax.block_until_ready(out.poses)
        t2 = time.time()
        res = plevel.unstack_maps(out)[:npair]
        t3 = time.time()
        self._last_timing = dict(prep=round(t1 - t0, 4),
                                 device=round(t2 - t1, 4),
                                 get=round(t3 - t2, 4), max_obs=mo)
        self.join_count += npair
        return res

    # -- full tree -----------------------------------------------------------
    def run(self, maps: list[types.LocalMap], ckpt_dir: str | None = None,
            resume: bool = False, metrics=None) -> types.LocalMap:
        level = 0
        if resume and ckpt_dir:
            from ..utils import checkpoint as ckpt
            state = ckpt.latest(ckpt_dir)
            if state is not None:
                level, maps = state
                log.info("resuming from checkpoint level %d (%d maps)",
                         level, len(maps))
        maps = [compact_mod.compact(lm, self.bucket, self.u_bucket) for lm in maps]
        count = len(maps)
        t0 = time.time()
        while count > 1:
            nxt = (count + 1) // 2
            npair = count // 2
            if self.strategy == "level" and npair > 1:
                merged = self._run_level_batched(
                    [maps[2 * i] for i in range(npair)],
                    [maps[2 * i + 1] for i in range(npair)])
            else:
                merged = [self.merge_pair(maps[2 * i], maps[2 * i + 1])
                          for i in range(npair)]
            out = []
            for i in range(nxt):
                g = merged[i] if i < npair else maps[2 * i]  # odd carry (:1946-1948)
                if (i + 1) % 2 == 0:
                    g = self.regauge_to_final(g)
                g = compact_mod.compact(g, self.bucket, self.u_bucket)
                out.append(g)
            maps = out
            count = nxt
            level += 1
            if metrics is not None:
                metrics.record(level, count, npair,
                               M=maps[0].M, N=maps[0].N,
                               **getattr(self, "_last_timing", {}))
            if ckpt_dir:
                from ..utils import checkpoint as ckpt
                ckpt.save_level(ckpt_dir, level, maps)
            if self.progress:
                log.info("Level %d done (%d maps, %.2fs)", level, count, time.time() - t0)
        g = self.regauge_to_final(maps[0])
        return compact_mod.compact(g, self.bucket, self.u_bucket)
