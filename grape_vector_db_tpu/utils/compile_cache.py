"""One place that decides where JAX keeps its persistent compile cache."""

from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["enable_compile_cache", "DEFAULT_CACHE_DIR"]

# Fixed path at the repository root (listed in .gitignore): the cache key
# includes the path, so a directory that moves between runs never hits.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Honour ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
    itself; nothing else is set). Otherwise keep the cache in the fixed
    ``.jax_cache/`` at the repository root. Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
