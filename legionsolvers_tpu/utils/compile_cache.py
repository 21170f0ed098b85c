"""Where compiled programs are cached between processes."""

from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and
    nothing is changed.  Otherwise the cache lives at the fixed
    ``<repo>/.jax_cache``: the path is part of the cache key, so it must
    not move between runs."""
    path = os.environ.get(ENV)
    if path:
        return path
    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
