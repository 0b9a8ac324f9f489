"""The one rule for JAX's persistent compilation cache.

Every entry point (the CLI, bench.py, chip_smoke.py, the test suite) calls
:func:`enable` before its first compile.  The cache lives in
``$JAX_COMPILATION_CACHE_DIR`` when that is set, and otherwise at the fixed
``<checkout>/.jax_cache`` (listed in .gitignore).  The directory is part of
the cache's key, so it never depends on a temp name, a pid or the time.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = 'JAX_COMPILATION_CACHE_DIR'
REPO_ROOT = Path(__file__).resolve().parents[2]


def cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get(ENV_VAR) or str(REPO_ROOT / '.jax_cache')


def enable() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir` and
    cache every program that takes a second or more to compile.  Returns
    the directory."""
    import jax

    path = cache_dir()
    jax.config.update('jax_compilation_cache_dir', path)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 1.0)
    jax.config.update('jax_persistent_cache_min_entry_size_bytes', 0)
    return path
