"""JAX persistent compilation cache at one fixed place.

The cache key includes the directory path, so a directory that moves
between runs never hits.  Every entry point (CLI, serving daemon, bench,
chip_smoke.py, benchmarks/) calls ``enable_compile_cache()`` before its
first compile:

  * if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses that
    directory and nothing is set in code;
  * otherwise the cache goes to ``<repo>/.cache/jax``.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".cache" / "jax"


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its one directory; returns it."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
