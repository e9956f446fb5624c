"""Persistent compilation cache location."""

from __future__ import annotations

import os
from pathlib import Path

import jax

REPO_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing else is set here; otherwise the cache goes to the fixed path
    ``<repo>/.jax_cache`` (a fixed path, because the path is part of the
    cache key)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE))
    return str(REPO_CACHE)
