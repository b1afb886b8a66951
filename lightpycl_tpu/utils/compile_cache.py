"""Where JAX keeps its persistent compilation cache.

Scripts, benchmarks and the test suite call `enable_compile_cache()` once,
before their first compile:

* `JAX_COMPILATION_CACHE_DIR` set: JAX reads it itself, and nothing is set
  in code.
* unset: the cache goes to `<checkout>/.jax_cache` (listed in .gitignore).
  The path is fixed, so a second run in the same checkout finds it again.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
