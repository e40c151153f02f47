import os
import tempfile

# Tests run on the CPU backend with 8 virtual devices (the mesh tests shard
# over them). Set before jax is imported; subprocesses inherit both.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

# A machine-local compile cache, never the checkout's .jax_cache: XLA:CPU
# cache keys don't include host machine features, so entries compiled on
# another machine can load here with a mismatched ISA (SIGILL risk). The
# cache pays off twice: identical programs recompiled across solver
# instances within one run (every equivalence test builds >= 2 solvers),
# and full reruns. Set before linearsfm_tpu is imported, which then leaves
# the cache directory to JAX; the two-process multihost workers inherit it.
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(tempfile.gettempdir(), "linearsfm_jax_cpu_cache"))
os.makedirs(os.environ["JAX_COMPILATION_CACHE_DIR"], exist_ok=True)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir",
                  os.environ["JAX_COMPILATION_CACHE_DIR"])
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
