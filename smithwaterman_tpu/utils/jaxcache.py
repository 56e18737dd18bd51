"""Persistent XLA compilation cache setup.

Shape-bucketed DP programs compile once per (bucket, mode); caching them on
disk makes every later process start warm.  The cache lives where
``JAX_COMPILATION_CACHE_DIR`` says, else at a fixed path inside the
checkout (``.jax_cache/``, listed in .gitignore): the path is part of the
cache key, so it must not move between runs.  Opt out with
``SWT_NO_COMPILE_CACHE=1``.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compilation_cache() -> None:
    if os.environ.get("SWT_NO_COMPILE_CACHE"):
        return
    import jax

    path = cache_dir()
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:  # read-only checkout: run uncached
        return
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
