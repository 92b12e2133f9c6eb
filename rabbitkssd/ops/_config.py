"""JAX runtime configuration shared by all device modules.

Imported for its side effect before any kernel is compiled: enables the
persistent compilation cache so every process after the first reuses
compiled executables.  The cache lives where ``JAX_COMPILATION_CACHE_DIR``
says, else at the fixed ``.jax_cache/`` of the checkout (a fixed path,
because the path is part of the cache key).
"""

import os

import jax

CACHE_DIR = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")
jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
# 64-bit hash values (use64 configs) flow through device ops as real
# uint64 arrays; kernels keep hot paths in explicit 32-bit dtypes.
jax.config.update("jax_enable_x64", True)
