"""Persistent XLA compilation cache.

A cold start compiles the fused Triton kernel and the XLA programs around
it from scratch; JAX's persistent compilation cache serves them on warm
starts instead (the Triton kernel included: it is embedded in the cached
executable). The reference has a compile boundary in the same place: it
rebuilds ``kernels.cl`` from source on every startup
(``Source/skeleton.cpp:380-421``) and relies on the driver's own binary
cache for warm starts.

The cache directory is part of every entry's key, so it is a fixed path:
``JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it itself, and nothing
here overrides it), otherwise ``<checkout>/.jax_cache``.
"""
from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")


def enable_compilation_cache(default: str = DEFAULT_CACHE_DIR) -> str:
    """Turn on the persistent compilation cache and return its directory.

    Caches every entry (min-compile-time/min-size floors lowered to zero:
    the cost is many medium compiles, not a few giant ones). With
    ``JAX_COMPILATION_CACHE_DIR`` set, JAX already uses that directory and
    no directory is set here; otherwise ``default`` is used."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = default
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
