"""Where JAX keeps its persistent compilation cache.

Every entry point (CLI, quick_test, bench, chip_smoke, the diagnose
scripts, the test suite) calls ``enable_compile_cache()`` once, before its
first compile. The cache path is part of what makes an entry hit, so it is
one fixed directory, never one built from a temp name, a pid or the time.
"""

from __future__ import annotations

import os
from pathlib import Path

# Checkout root / .jax_cache (listed in .gitignore).
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    function changes nothing. Otherwise it sets ``DEFAULT_CACHE_DIR``, and
    no other option."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
