"""linearsfm_tpu: a Linear SFM engine in JAX/XLA.

A from-scratch rebuild of the hierarchical linear structure-from-motion solver
(reference: LiangZhaoPKUImperial/LinearSFM, C++/CHOLMOD, single-threaded CPU)
as batched device programs: block tensors, autodiff gauge Jacobians, dense
Schur solves, shard_map map-parallel merge trees.

Double precision is required for information-matrix fusion; we enable x64 at
import (the reference is entirely double precision,
/root/reference/linux/src/LinearSFMImp/LinearSFMImp.h:110-120).
"""

import os

import jax

jax.config.update("jax_enable_x64", True)
# f32 matmuls must keep full f32 precision: on the GPU the default lets them
# run in TF32, which keeps about three decimal digits and would degrade the
# f32 Schur factor that preconditions the f64 solve (ops/schur.py).
jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: JAX reads JAX_COMPILATION_CACHE_DIR itself;
# without it, use the checkout's fixed .jax_cache/ (a fixed path, so later
# runs find what earlier ones compiled).
if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
            __file__))), ".jax_cache"))

from .types import LocalMap, Gauge  # noqa: E402,F401
from .version import __version__  # noqa: E402,F401
