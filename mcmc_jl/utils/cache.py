"""Where JAX keeps its persistent compilation cache."""
from __future__ import annotations

import os
import pathlib

#: the checkout's own cache directory (listed in .gitignore)
CHECKOUT_CACHE = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache():
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is changed here; otherwise the cache is ``<checkout>/.jax_cache``,
    a fixed path, so that later runs of this checkout find it again."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    return str(CHECKOUT_CACHE)
