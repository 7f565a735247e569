"""Persistent XLA compilation cache setup.

The training and encode loops compile one program per shape bucket;
the persistent cache makes each compile a one-time cost per machine
instead of per process.

Rule: where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself
and this module sets no directory; otherwise the cache lives at a fixed
path, ``<checkout>/.jax_cache`` (the path is part of a cache entry's
key, so a directory that moves never hits).
"""

from __future__ import annotations

import os

import jax

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")

_DONE = False


def ensure_jax_cache() -> None:
    """Idempotently point JAX at the persistent compilation cache."""
    global _DONE
    if _DONE:
        return
    _DONE = True
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
