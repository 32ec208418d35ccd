"""Process set-up shared by the entry points (bench.py, chip_smoke.py,
tools/cli.py, tools/parity.py): platform choice, the persistent compile
cache, and the default autotune table. Everything lives inside the checkout.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# JAX's persistent compilation cache when JAX_COMPILATION_CACHE_DIR is unset
COMPILE_CACHE = os.path.join(CHECKOUT, ".jax_cache")
# the measured per-(device kind, shape, pattern) arm table
# (engine/autotune.py)
AUTOTUNE_TABLE = os.path.join(CHECKOUT, ".autotune_cache.json")

PLATFORMS = ("auto", "cpu", "gpu")


def select_platform(name: str) -> str:
    """Pin jax to ``name`` ("auto" leaves JAX's own choice). Call before
    the first device use. Returns the backend in use."""
    import jax

    if name not in PLATFORMS:
        raise ValueError(f"platform {name!r} not in {PLATFORMS}")
    if name != "auto":
        jax.config.update("jax_platforms", name)
    return jax.default_backend()


def setup_compile_cache() -> str:
    """Keep compiled executables across processes. JAX_COMPILATION_CACHE_DIR,
    when set, is JAX's own and is left alone; otherwise the cache goes to
    the fixed `COMPILE_CACHE` path (a path that moves never hits). Returns
    the directory in use."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return COMPILE_CACHE
