"""Where the entry points keep JAX's persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and wins:
nothing here overrides it.  Otherwise the cache lives at the fixed
``<checkout>/.jax_cache`` (git-ignored), so every process started from one
checkout finds what an earlier one compiled.  The library never enables the
cache by itself; entry points (``bench.py``, ``chip_smoke.py``,
``__graft_entry__.py``) call :func:`enable_compile_cache`.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = Path(__file__).resolve().parents[2]


def compile_cache_dir() -> str:
    """The cache directory the entry points use."""
    return os.environ.get(ENV_VAR) or str(CHECKOUT / ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent cache for this process; returns its path."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
