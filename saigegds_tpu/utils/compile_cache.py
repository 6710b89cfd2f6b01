"""Persistent XLA compile cache for the repository's launchers.

Importing the package sets no cache.  The launchers (``python -m
saigegds_tpu``, ``chip_smoke.py``, ``bench.py`` and the test suite) call
:func:`enable_compile_cache` before their first compile, so a process
reuses what an earlier one compiled for the same program and shapes.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# a fixed path: the cache key includes the directory, so one that moved
# between runs would never hit
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Return the compile-cache directory in use.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here.  Otherwise the cache goes to
    ``<checkout>/.jax_cache``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
