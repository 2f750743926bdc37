"""Persistent XLA compilation cache setup.

Frame compiles of the build/trace pipelines take seconds to minutes; the
cache lets later processes skip them. Call once at program start
(bench.py, chip_smoke.py, the CLI and __graft_entry__ all do).
"""

from __future__ import annotations

import os

REPO_CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")


def enable() -> str:
    """Point JAX's persistent cache at JAX_COMPILATION_CACHE_DIR when it is
    set (JAX reads that variable itself; nothing is overridden), else at
    the fixed <repo>/.jax_cache. Returns the directory in use."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return jax.config.jax_compilation_cache_dir
