"""Where JAX keeps its persistent compile cache, for every entry point.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
set here. Otherwise the cache lives at a fixed ``.jax_cache`` directory in
the checkout: the path is part of what the cache is found by, so it must
not move between runs.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
