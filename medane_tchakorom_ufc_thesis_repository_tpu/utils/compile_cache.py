"""Where JAX keeps its persistent compilation cache.

The entry points (the CLI, ``bench.py``, ``chip_smoke.py``) call
``enable_compile_cache()`` once before compiling; importing the package
changes nothing.  The cache's key includes its directory, so the
directory is fixed: ``JAX_COMPILATION_CACHE_DIR`` when the environment
sets it (JAX then reads it itself and no path is set here), otherwise
``.jax_cache`` at the root of the checkout (git-ignored).
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; return its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
