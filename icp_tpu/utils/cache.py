"""Persistent XLA compile cache, one fixed place per checkout.

Every entry point calls ``enable_compile_cache()`` before it compiles.  If
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is set
here.  Otherwise the cache goes to ``.jax_cache/`` at the root of the
checkout (listed in ``.gitignore``).  The path is part of the cache key, so
it is never built from a temporary name, a process id or the time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> str:
    """The directory the compile cache lives in."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at ``cache_dir()``; returns it."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
