"""Persistent-compilation-cache setup that hits across processes.

Where the cache lives: ``$JAX_COMPILATION_CACHE_DIR`` when it is set (and
then no other directory is configured), otherwise the fixed
``<checkout>/.jax_cache``. The path is part of nothing but the lookup, so
a fixed path is what lets a second process find the first one's entries.

Why ``stable_keys``: JAX cache keys hash the canonicalized StableHLO
module with location metadata stripped — but a Pallas kernel lowers to a
custom call whose backend payload is an OPAQUE serialized module (the
Triton module on the GPU route). That inner module carries its own
location table, and with JAX's default
``jax_include_full_tracebacks_in_locations=True`` every location holds the
FULL user call stack — including the entry script's filename and line
numbers. The outer canonicalization cannot see into the payload, so any
change to the call path (a differently named script, a ``python -c``
one-liner, an edit above the call site) changes the payload bytes and
therefore the cache key. ``enable_persistent_cache`` therefore pins
``jax_include_full_tracebacks_in_locations=False``: locations keep the
primary frame — the kernel's own source line — which only changes when
the library source itself changes. Call it before building any solver
program; it is idempotent.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

DEFAULT_MIN_COMPILE_SECS = 1.0
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# <checkout>/.jax_cache (listed in .gitignore)
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    """The directory the persistent cache uses: the environment's
    ``JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache``."""
    return os.environ.get(ENV_VAR) or str(DEFAULT_CACHE_DIR)


def enable_persistent_cache(
        min_compile_secs: float = DEFAULT_MIN_COMPILE_SECS,
        stable_keys: bool = True) -> str:
    """Enable the on-disk compilation cache with cross-process-stable keys
    and return its directory (see ``cache_dir``).

    Args:
      min_compile_secs: only persist programs that took at least this long
        to compile.
      stable_keys: disable full call-stack tracebacks in MLIR locations so
        Pallas payload bytes — and hence cache keys — do not depend on the
        caller's filename/line numbers (see module docstring). Set False
        to keep JAX's default rich locations (better error tracebacks, but
        kernels' cache entries stop hitting across entry points).
    """
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    if stable_keys:
        jax.config.update("jax_include_full_tracebacks_in_locations", False)
    return path
