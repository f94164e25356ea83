"""Persistent XLA compile cache location.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing
here overrides it.  Otherwise the entry points (cli, bench.py,
chip_smoke.py) keep the cache at one fixed path inside the checkout,
`.jax_cache/` (listed in .gitignore): the path is part of the cache key,
so a directory that moved would never hit.
"""

from __future__ import annotations

import os
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]


def cache_dir(environ=None) -> str | None:
    """The directory the program should set, or None when the
    environment already names one."""
    environ = os.environ if environ is None else environ
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(REPO_ROOT / ".jax_cache")


def configure_compile_cache() -> str | None:
    """Point JAX at `cache_dir()` unless the environment names one;
    returns the directory set, or None."""
    path = cache_dir()
    if path is not None:
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path
