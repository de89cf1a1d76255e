"""JAX's persistent compilation cache for the program's entry points.

A cold run compiles the whole per-frame step (four LM levels and the depth
frontend) and the mapping backend; the cache lets a later process skip that.
The cache is keyed by its directory, so the directory never moves: it is
``JAX_COMPILATION_CACHE_DIR`` where that is set (JAX reads the variable
itself), and otherwise ``.jax_cache`` at the root of the checkout.
"""

from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """The directory the entry points keep compiled programs in."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(_CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on at :func:`compile_cache_dir`; returns it."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
