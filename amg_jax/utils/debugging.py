"""Numerics debugging helpers — the analog of the reference's
valgrind memcheck CI stage (SURVEY.md §5: determinism checks, NaN
debugging, cross-shard consistency)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def enable_nan_checks():
    """Raise on any NaN produced inside jitted code (jax_debug_nans)."""
    jax.config.update("jax_debug_nans", True)


def disable_nan_checks():
    jax.config.update("jax_debug_nans", False)


def assert_reproducible(fn, *args, runs: int = 2):
    """Assert a device computation is bitwise-reproducible run-to-run."""
    outs = [np.asarray(jax.block_until_ready(fn(*args)))
            for _ in range(runs)]
    for o in outs[1:]:
        np.testing.assert_array_equal(outs[0], o)
    return outs[0]


def assert_shards_consistent(arr, mesh, expected_spec):
    """Assert a replicated-spec array holds identical values on every
    device (cross-shard consistency check for distributed solvers)."""
    vals = [np.asarray(s.data) for s in arr.addressable_shards]
    for v in vals[1:]:
        np.testing.assert_array_equal(vals[0], v)
