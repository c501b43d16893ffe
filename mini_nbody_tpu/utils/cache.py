"""Persistent XLA compilation cache.

One helper for every entry point (``cli.main``, ``bench.py``,
``chip_smoke.py``): compiling the Pallas kernel and the step scans for a
new shape takes seconds to minutes, and a cache keyed by a fixed path lets a
later process reuse them.
"""

from __future__ import annotations

import os
from pathlib import Path

#: In-checkout cache directory (listed in .gitignore).
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a directory and return it.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing
    is set in code. Otherwise the cache goes to the fixed in-checkout
    DEFAULT_DIR."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    DEFAULT_DIR.mkdir(exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
