"""Determinism checks — the analog of the reference's valgrind
memcheck CI (SURVEY.md §5): same inputs must give bitwise-identical
results run-to-run."""

import jax
import numpy as np
import jax.numpy as jnp

from amg_jax.models import poisson
from amg_jax.multigrid import Multigrid
from amg_jax.ops.smoothers import MulticolorGaussSeidel
from amg_jax.structured import (build_stencil_hierarchy, solve_stencil,
                                vcycle_stencil)
from amg_jax.utils.debugging import (assert_reproducible,
                                     assert_shards_consistent)


def test_structured_solve_bitwise_deterministic():
    side = 31
    hier = build_stencil_hierarchy(side, dtype=jnp.float64)
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    r1 = solve_stencil(hier, b2, tolerance=1e-9,
                       compute_error_every_n_iters=1)
    r2 = solve_stencil(hier, b2, tolerance=1e-9,
                       compute_error_every_n_iters=1)
    assert r1.iterations == r2.iterations
    np.testing.assert_array_equal(np.asarray(r1.u), np.asarray(r2.u))


def test_vcycle_reproducible_helper():
    """utils.debugging.assert_reproducible on the jitted V-cycle."""
    side = 31
    hier = build_stencil_hierarchy(side, dtype=jnp.float64)
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    step = jax.jit(lambda h, u, b: vcycle_stencil(h, u, b))
    assert_reproducible(lambda: step(hier, jnp.zeros_like(b2), b2),
                        runs=3)


def test_dist_solution_shards_consistent():
    """utils.debugging.assert_shards_consistent: the replicated
    (agglomerated) solve result must be identical on every device."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from amg_jax.parallel.structured_dist import DistStructuredSolver

    side = 31
    s = DistStructuredSolver(side, n_devices=8, dtype=jnp.float64)
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    res = s.solve(b2, tolerance=1e-9, compute_error_every_n_iters=1,
                  n_iters=30)
    u_repl = jax.device_put(res.u, NamedSharding(s.mesh, P()))
    assert_shards_consistent(u_repl, s.mesh, P())


def test_ell_solve_bitwise_deterministic():
    n = 15
    A, b = poisson.poisson2d(n)
    res = []
    for _ in range(2):
        amg = Multigrid(None, MulticolorGaussSeidel(), A, b, 4, 1e-9, 5, 100)
        res.append(amg.solve(verbose=False))
    assert res[0].iterations == res[1].iterations
    np.testing.assert_array_equal(np.asarray(res[0].u),
                                  np.asarray(res[1].u))


def test_nonconvergence_surfaced_structured():
    """`solve` reports non-convergence in the result object (the reference
    only prints, multigrid.hpp:329-334)."""
    n = 15
    A, b = poisson.poisson2d(n)
    amg = Multigrid(None, None, A, b, 4, 1e-30, 2, 2)
    res = amg.solve(verbose=False)
    assert not res.converged
    assert res.iterations == 2
