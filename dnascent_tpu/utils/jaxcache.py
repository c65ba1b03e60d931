"""Persistent XLA compilation cache setup.

Compiles dominate a cold start, so the package enables JAX's on-disk
compilation cache when it is imported (``dnascent_tpu/__init__.py``, the one
caller).  If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps its cache there
and no other directory is configured.  Otherwise the cache lives at a fixed
path inside the checkout, ``<repo>/.jax_cache`` (git-ignored): the path is
part of the cache key, so it must not move between runs."""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compilation_cache() -> None:
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(DEFAULT_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
