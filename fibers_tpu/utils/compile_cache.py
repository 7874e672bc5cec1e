"""Where JAX's persistent compilation cache lives.

One helper for every entry point (the CLI, the benchmark scripts and
`chip_smoke.py`), so a process started by any of them finds what an
earlier one compiled.
"""

from __future__ import annotations

import os

__all__ = ["CHECKOUT_CACHE_DIR", "enable_compile_cache"]

# A fixed path inside the checkout: the cache directory is part of the
# cache's key, so a path that moved between runs would never hit.
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    `JAX_COMPILATION_CACHE_DIR`, when set, is JAX's own setting and is
    used as it is: no other directory is set.  Otherwise the cache goes
    to `CHECKOUT_CACHE_DIR`.  Every compile is cached, not only those
    above JAX's default one-second threshold."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = CHECKOUT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
