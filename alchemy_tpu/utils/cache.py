"""Where compiled programs persist between processes.

Both caches live at fixed paths inside the checkout (git-ignored), so a
second run of the same code finds what the first one compiled: JAX's
persistent compile cache, and the AOT export cache of interp/jit_exec.py.
"""

from __future__ import annotations

import os

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
COMPILE_CACHE_DIR = os.path.join(_ROOT, ".cache", "jax")
AOT_CACHE_DIR = os.path.join(_ROOT, ".cache", "aot")


def setup_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this
    sets nothing; otherwise the cache goes to COMPILE_CACHE_DIR."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    return COMPILE_CACHE_DIR
