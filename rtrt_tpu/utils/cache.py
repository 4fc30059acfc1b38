"""Persistent XLA compilation cache, shared by every entry point."""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    `JAX_COMPILATION_CACHE_DIR`, when set, is JAX's own setting and wins:
    nothing here overrides it.  Otherwise the cache lives in one fixed
    directory of the checkout (`.jax_cache/`, git-ignored): the path is
    part of the cache key, so it must not move between runs."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
