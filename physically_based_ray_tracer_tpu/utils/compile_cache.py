"""JAX's persistent compilation cache, in one place.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses that directory and
nothing else is set here. Otherwise the cache is ``<checkout>/.jax_cache``:
a fixed path, so later runs from the same checkout find what earlier ones
compiled.
"""

from __future__ import annotations

import os

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_DIR, ".jax_cache")


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at ``cache_dir()``; returns the path."""
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
