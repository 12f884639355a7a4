"""Where JAX keeps its persistent compile cache.

A map-step compile costs seconds to minutes per (B, L) bucket; the
persistent cache turns every later run's compile into a load.  Its path
is part of what makes an entry hit, so the path is fixed: the directory
that `JAX_COMPILATION_CACHE_DIR` names when it is set (JAX reads the
variable itself), otherwise `.jax_cache/` at the root of the checkout.
"""

from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its fixed directory and
    return that directory.  Call before the first compile."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
