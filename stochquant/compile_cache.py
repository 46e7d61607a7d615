"""Where JAX keeps its persistent compilation cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here overrides it.  Otherwise the cache goes to ``.jax_cache`` at the root
of the checkout (listed in ``.gitignore``): a fixed path, because the path
is part of what a cached program is found under.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def configure() -> str:
    """Point JAX's persistent compilation cache at its directory; returns
    the directory in use."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
