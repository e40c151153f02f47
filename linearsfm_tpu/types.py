"""Core data model: padded, batched block-sparse local maps as JAX pytrees.

The reference keeps a local map as pointer-soup of variable-length block lists
(`LocalMapInfo{,Stereo}`, /root/reference/linux/src/LinearSFMImp/LinearSFMImp.h:75-178).
The representation here is a fixed-capacity pytree of dense batched
tensors with validity masks, so every pairwise join compiles to a single static
XLA program and whole tree levels can be vmapped/shard_mapped over a mesh axis.

Layout (capacities M/N/KU/KW are static; valid counts are traced scalars):

- ``pose_ids[M]`` int32: original pose id of each pose slot, ``-1`` padding.
- ``poses[M,6]``: ``(tx,ty,tz, alpha,beta,gamma)`` with ``R = Rx(g)Ry(b)Rz(a)``
  (reference rotation convention, LinearSFMImp.cpp:132-143).
- ``feat_ids[N]`` int32 / ``feats[N,3]``: feature slots.
- Block-sparse information matrix in COO-of-blocks form with **scatter-add
  semantics** (duplicate coordinates are summed; symmetric completion implied:
  an off-diagonal block (i,j) also contributes its transpose at (j,i)):
  ``U[KU,6,6]`` with ``Uij[KU,2]`` pose-slot pairs, ``W[KW,6,3]`` with
  ``Wpf[KW,2]`` (pose-slot, feat-slot), ``V[N,3,3]`` block-diagonal.
  Padding entries have zero blocks and index (0,0) so they contribute nothing.
- Gauge tags mirror the reference: ``ref``/``scap``/``fix``/``sign`` plus the
  final-frame tags ``fref``/``fscap``/``ffix`` used for re-normalization
  (LinearSFMImp.h:119, :174-176). Stereo maps use only ``ref``/``fref``.

Stereo maps do NOT contain their reference pose as a slot (it is the implicit
identity); mono maps DO contain it, with value zero (LinearSFMImp.cpp:3284-3294).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _register(cls, data_fields, meta_fields=()):
    return jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields)
    )


@partial(_register, data_fields=("ref", "scap", "fix", "sign", "fref", "fscap", "ffix"))
@dataclasses.dataclass(frozen=True)
class Gauge:
    """Gauge tags of a local map (all traced int32 scalars)."""

    ref: jax.Array   # reference pose id
    scap: jax.Array  # scale pose id (mono; -1 for stereo)
    fix: jax.Array   # pinned coordinate of scap in {0,1,2} (mono; -1 stereo)
    sign: jax.Array  # sign of the pinned coordinate (+-1; mono)
    fref: jax.Array  # final (first map's) reference id
    fscap: jax.Array
    ffix: jax.Array

    @staticmethod
    def stereo(ref: int, fref: int | None = None) -> "Gauge":
        # numpy scalars: stay host-side until a jit boundary (a jnp scalar
        # would live on the device and cost a transfer per host read).
        i = lambda v: np.int32(v)
        return Gauge(i(ref), i(-1), i(-1), i(1), i(ref if fref is None else fref), i(-1), i(-1))

    @staticmethod
    def mono(ref: int, scap: int, fix: int, sign: int = 1,
             fref: int | None = None, fscap: int | None = None,
             ffix: int | None = None) -> "Gauge":
        i = lambda v: np.int32(v)
        return Gauge(
            i(ref), i(scap), i(fix), i(sign),
            i(ref if fref is None else fref),
            i(scap if fscap is None else fscap),
            i(fix if ffix is None else ffix),
        )


@partial(
    _register,
    data_fields=(
        "pose_ids", "poses", "feat_ids", "feats",
        "U", "Uij", "W", "Wpf", "V",
        "n_poses", "n_feats", "n_U", "n_W", "gauge",
    ),
)
@dataclasses.dataclass(frozen=True)
class LocalMap:
    """A (possibly merged) local map: state estimate + block information matrix."""

    pose_ids: jax.Array  # i32[M]
    poses: jax.Array     # f[M,6]
    feat_ids: jax.Array  # i32[N]
    feats: jax.Array     # f[N,3]
    U: jax.Array         # f[KU,6,6]
    Uij: jax.Array       # i32[KU,2]
    W: jax.Array         # f[KW,6,3]
    Wpf: jax.Array       # i32[KW,2]
    V: jax.Array         # f[N,3,3]
    n_poses: jax.Array   # i32 scalar (valid pose slots)
    n_feats: jax.Array   # i32 scalar
    n_U: jax.Array       # i32 scalar
    n_W: jax.Array       # i32 scalar
    gauge: Gauge

    # ---- static capacities -------------------------------------------------
    @property
    def M(self) -> int:
        return self.poses.shape[0]

    @property
    def N(self) -> int:
        return self.feats.shape[0]

    @property
    def KU(self) -> int:
        return self.U.shape[0]

    @property
    def KW(self) -> int:
        return self.W.shape[0]

    @property
    def dtype(self):
        return self.poses.dtype

    # ---- masks -------------------------------------------------------------
    # Validity is id-based (-1 = dead/padding): mono joins leave dead slots in
    # the middle of the pose range, so count-based masks would be wrong.
    def pose_mask(self) -> jax.Array:
        return self.pose_ids >= 0

    def feat_mask(self) -> jax.Array:
        return self.feat_ids >= 0

    def u_mask(self) -> jax.Array:
        return jnp.arange(self.KU) < self.n_U

    def w_mask(self) -> jax.Array:
        return jnp.arange(self.KW) < self.n_W

    def ref_slot(self) -> jax.Array:
        """Slot index of the pose tagged with the gauge reference id (mono /
        post-transform stereo maps; matches `find(stno, -Ref)` idiom,
        LinearSFMImp.cpp:389-390)."""
        return jnp.argmax(self.pose_ids == self.gauge.ref)

    def scap_slot(self) -> jax.Array:
        return jnp.argmax(self.pose_ids == self.gauge.scap)

    def pad_to(self, M=None, N=None, KU=None, KW=None) -> "LocalMap":
        """Grow capacities (no-op on axes already large enough).

        Host-side operation (numpy): used between tree levels where maps
        live on the host; keeps per-map device ops off the level loop."""
        M = self.M if M is None else max(M, self.M)
        N = self.N if N is None else max(N, self.N)
        KU = self.KU if KU is None else max(KU, self.KU)
        KW = self.KW if KW is None else max(KW, self.KW)

        def padr(x, k, fill=0):
            x = np.asarray(x)
            pad = [(0, k - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
            return np.pad(x, pad, constant_values=fill)

        return dataclasses.replace(
            self,
            pose_ids=padr(self.pose_ids, M, -1), poses=padr(self.poses, M),
            feat_ids=padr(self.feat_ids, N, -1), feats=padr(self.feats, N),
            U=padr(self.U, KU), Uij=padr(self.Uij, KU),
            W=padr(self.W, KW), Wpf=padr(self.Wpf, KW),
            V=padr(self.V, N),
        )


def make_local_map(pose_ids, poses, feat_ids, feats, U, Uij, W, Wpf, V, gauge,
                   dtype=jnp.float64) -> LocalMap:
    """Build a LocalMap from exact-size (unpadded) host arrays.

    Arrays stay host-side (numpy); they move to device lazily at the first
    jit boundary, where each transfer has real latency."""
    import numpy as _np
    npdtype = _np.dtype(dtype) if dtype != jnp.float64 else _np.float64
    pose_ids = _np.asarray(pose_ids, _np.int32)
    feat_ids = _np.asarray(feat_ids, _np.int32)
    f = lambda x: _np.asarray(x, npdtype)
    i32 = lambda v: _np.asarray(v, _np.int32)
    Uij = _np.asarray(Uij, _np.int32).reshape(-1, 2)
    Wpf = _np.asarray(Wpf, _np.int32).reshape(-1, 2)
    return LocalMap(
        pose_ids=pose_ids, poses=f(poses).reshape(-1, 6),
        feat_ids=feat_ids, feats=f(feats).reshape(-1, 3),
        U=f(U).reshape(-1, 6, 6), Uij=Uij,
        W=f(W).reshape(-1, 6, 3), Wpf=Wpf,
        V=f(V).reshape(-1, 3, 3),
        n_poses=i32(len(pose_ids)), n_feats=i32(len(feat_ids)),
        n_U=i32(Uij.shape[0]), n_W=i32(Wpf.shape[0]),
        gauge=gauge,
    )


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def bucket(x: int, mult: int = 64) -> int:
    """Shape bucket for jit caching: next multiple of `mult` (min `mult`)."""
    return max(mult, round_up(x, mult))
