"""Persistent XLA compilation cache.

Compiling the unrolled wavefront program takes far longer than running
it, so a persistent on-disk cache makes every program a one-time cost
across processes (bench runs, CLI renders, tests). Call enable() before
the first jit dispatch; it is idempotent and safe on any backend.

Where the cache lives: JAX_COMPILATION_CACHE_DIR when it is set (JAX
reads it itself, and this module sets no other directory), else the
fixed <repo>/.jax_cache. The path is part of the cache key, so it must
not move between runs.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache"))


def cache_dir() -> str:
    """The directory the compile cache uses (see module docstring)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # Cache every program regardless of size/compile time.
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
