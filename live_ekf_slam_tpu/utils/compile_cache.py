"""Persistent XLA compilation cache for the program's entry points.

``enable_compile_cache()`` is called by ``cli.main``, ``bench.py`` and
``chip_smoke.py``. The cache directory is part of the cache key, so it is
a fixed path: ``$JAX_COMPILATION_CACHE_DIR`` when the environment sets it
(JAX reads that variable itself, and nothing else is set), otherwise
``.jax_cache/`` at the root of the checkout (listed in .gitignore).
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
