"""AMG-preconditioned CG tests (production extension beyond the
reference's plain V-cycle iteration)."""

import numpy as np
import jax.numpy as jnp

from amg_jax.krylov import solve_pcg_stencil
from amg_jax.models import poisson
from amg_jax.structured import build_stencil_hierarchy, solve_stencil


def test_pcg_converges_fewer_iterations():
    side = 31
    hier = build_stencil_hierarchy(side, dtype=jnp.float64)
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    pcg = solve_pcg_stencil(hier, b2, tolerance=1e-9, n_iters=50)
    assert pcg.converged
    plain = solve_stencil(hier, b2, tolerance=1e-9,
                          compute_error_every_n_iters=1)
    assert pcg.iterations <= plain.iterations
    A = poisson.laplacian_scipy(side)
    u_direct = np.linalg.solve(A.toarray(), np.asarray(b2).reshape(-1))
    np.testing.assert_allclose(np.asarray(pcg.u).reshape(-1), u_direct,
                               rtol=0, atol=1e-7)


def test_pcg_nonconvergence_reported():
    """Non-convergence surfaces as a structured result, not a print
    (SURVEY.md §5 failure-detection note)."""
    side = 15
    hier = build_stencil_hierarchy(side, dtype=jnp.float64)
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    res = solve_pcg_stencil(hier, b2, tolerance=1e-30, n_iters=2)
    assert not res.converged
    assert res.iterations == 2


def test_pcg_device_matches_host_loop():
    """Device-resident PCG (one lax.while_loop dispatch) must walk the
    exact same iteration as the host-stepped debug loop."""
    from amg_jax.krylov import solve_pcg_device
    from amg_jax.structured import build_stencil_hierarchy_device

    side = 63
    hier = build_stencil_hierarchy_device(side, smoother="packed")
    b2 = poisson.rhs(side, dtype=jnp.float32).reshape(side, side)
    u, stats = solve_pcg_device(hier, b2, tolerance=1e-7, n_iters=50)
    err, it = np.asarray(stats)
    ref = solve_pcg_stencil(hier, b2, tolerance=1e-7, n_iters=50)
    assert ref.converged and err <= 1e-7
    assert int(it) == ref.iterations
    np.testing.assert_array_equal(np.asarray(u), np.asarray(ref.u))


def test_pcg_device_budget_exhaustion():
    from amg_jax.krylov import solve_pcg_device
    from amg_jax.structured import build_stencil_hierarchy_device

    side = 31
    hier = build_stencil_hierarchy_device(side, smoother="packed")
    b2 = poisson.rhs(side, dtype=jnp.float32).reshape(side, side)
    u, stats = solve_pcg_device(hier, b2, tolerance=1e-30, n_iters=3)
    err, it = np.asarray(stats)
    assert int(it) == 3 and err > 1e-30
