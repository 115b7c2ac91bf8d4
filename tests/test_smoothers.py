"""Smoother unit tests mirroring the reference suite (test/testlib.cpp:64-115)
plus multicolor-vs-sequential equivalence checks."""

import numpy as np
import jax.numpy as jnp
import pytest

from amg_jax.models import poisson
from amg_jax.ops.smoothers import (Jacobi, MulticolorGaussSeidel,
                                   SparseGaussSeidel,
                                   SuccessiveOverRelaxation)
from amg_jax.utils.coloring import greedy_coloring, red_black_2d


def tiny_problem():
    """2x2-interior (4-dof) Poisson with direct-solve oracle
    (testlib.cpp:17-35)."""
    A, b = poisson.poisson2d(2)
    u_exact = jnp.linalg.solve(A.to_dense(), b)
    return A, b, u_exact


def test_sor_invalid_omega_raises():
    """SOR throws on omega < 0 and omega > 2 (testlib.cpp:64-71,
    smoother.hpp:286-293)."""
    with pytest.raises(ValueError):
        SuccessiveOverRelaxation(omega=-0.01)
    with pytest.raises(ValueError):
        SuccessiveOverRelaxation(omega=2.01)
    with pytest.raises(ValueError):
        MulticolorGaussSeidel(omega=-0.5)


def test_jacobi_matches_direct_oracle():
    """Jacobi converges to the direct solution on the 4-dof problem with 100
    iterations (testlib.cpp:76-81)."""
    A, b, u_exact = tiny_problem()
    sm = Jacobi(n_iters=100)
    res = sm.smooth(A, jnp.zeros_like(b), b)
    np.testing.assert_allclose(np.asarray(res.u), np.asarray(u_exact),
                               rtol=0, atol=1e-8)


def test_sor_matches_direct_oracle():
    """(testlib.cpp:89-94)"""
    A, b, u_exact = tiny_problem()
    sm = SuccessiveOverRelaxation(omega=1.0, n_iters=100)
    res = sm.smooth(A, jnp.zeros_like(b), b)
    np.testing.assert_allclose(np.asarray(res.u), np.asarray(u_exact),
                               rtol=0, atol=1e-9)


def test_spgs_matches_direct_oracle():
    """(testlib.cpp:102-107)"""
    A, b, u_exact = tiny_problem()
    sm = SparseGaussSeidel(n_iters=100)
    res = sm.smooth(A, jnp.zeros_like(b), b)
    np.testing.assert_allclose(np.asarray(res.u), np.asarray(u_exact),
                               rtol=0, atol=1e-9)


def test_base_ctor_variants():
    """3-arg base-ctor smoke test (testlib.cpp:109-115)."""
    Jacobi(1e-10, 100, 100)
    SuccessiveOverRelaxation(1.0, 1e-10, 100, 100)


def test_sequential_gs_matches_handwritten_sweep():
    """The triangular-solve sweep equals an explicit Python lexicographic
    Gauss-Seidel sweep (the reference recurrence, smoother.hpp:129-174)."""
    n = 5
    A, b = poisson.poisson2d(n)
    dense = np.asarray(A.to_dense())
    bn = np.asarray(b)
    rng = np.random.default_rng(42)
    u0 = rng.standard_normal(n * n)

    # handwritten forward + backward sweep
    u = u0.copy()
    N = n * n
    for i in range(N):
        s = dense[i] @ u - dense[i, i] * u[i]
        u[i] = (bn[i] - s) / dense[i, i]
    for i in range(N - 1, -1, -1):
        s = dense[i] @ u - dense[i, i] * u[i]
        u[i] = (bn[i] - s) / dense[i, i]

    sm = SparseGaussSeidel()
    state = sm.setup(A)
    u_jax = sm.apply(state, jnp.asarray(u0), b)
    np.testing.assert_allclose(np.asarray(u_jax), u, rtol=1e-12)


def test_sor_omega_matches_handwritten():
    n = 4
    A, b = poisson.poisson2d(n)
    dense = np.asarray(A.to_dense())
    bn = np.asarray(b)
    omega = 1.3
    rng = np.random.default_rng(3)
    u0 = rng.standard_normal(n * n)
    u = u0.copy()
    for i in range(n * n):
        s = dense[i] @ u - dense[i, i] * u[i]
        gs = (bn[i] - s) / dense[i, i]
        u[i] = u[i] + omega * (gs - u[i])
    sm = SuccessiveOverRelaxation(omega=omega)
    u_jax = sm.apply(sm.setup(A), jnp.asarray(u0), b)
    np.testing.assert_allclose(np.asarray(u_jax), u, rtol=1e-12)


def test_multicolor_gs_matches_color_ordered_sequential():
    """A multicolor sweep equals sequential GS visited in color order."""
    n = 6
    A, b = poisson.poisson2d(n)
    dense = np.asarray(A.to_dense())
    bn = np.asarray(b)
    colors = red_black_2d(n)
    rng = np.random.default_rng(7)
    u0 = rng.standard_normal(n * n)

    u = u0.copy()
    order = np.concatenate([np.nonzero(colors == c)[0] for c in range(2)])
    for i in order:
        s = dense[i] @ u - dense[i, i] * u[i]
        u[i] = (bn[i] - s) / dense[i, i]

    sm = MulticolorGaussSeidel(symmetric=False)
    u_jax = sm.apply(sm.setup(A), jnp.asarray(u0), b)
    np.testing.assert_allclose(np.asarray(u_jax), u, rtol=1e-12)


def test_multicolor_gs_converges():
    A, b, u_exact = tiny_problem()
    sm = MulticolorGaussSeidel(n_iters=100)
    res = sm.smooth(A, jnp.zeros_like(b), b)
    np.testing.assert_allclose(np.asarray(res.u), np.asarray(u_exact),
                               rtol=0, atol=1e-9)


def test_greedy_coloring_valid_and_redblack_on_stencil():
    """Greedy coloring is a proper coloring; on the 5-point stencil it
    produces exactly 2 colors (red-black)."""
    n = 8
    A = poisson.laplacian(n)
    cols = np.asarray(A.cols)
    data = np.asarray(A.data)
    colors = greedy_coloring(cols, data, n * n)
    assert colors.max() == 1  # 2 colors
    # proper: no edge joins same-colored rows
    for i in range(n * n):
        for k in range(cols.shape[1]):
            j = cols[i, k]
            if data[i, k] != 0 and j != i:
                assert colors[i] != colors[j]
    np.testing.assert_array_equal(colors, red_black_2d(n))


def test_smoother_stopping_cadence():
    """Error checked every `compute_error_every_n_iters`; iteration count is
    a multiple of the cadence on convergence (smoother.hpp:195-198)."""
    A, b, _ = tiny_problem()
    sm = SparseGaussSeidel(tolerance=1e-9, compute_error_every_n_iters=7,
                           n_iters=1000)
    res = sm.smooth(A, jnp.zeros_like(b), b)
    assert res.converged
    assert res.iterations % 7 == 0
    assert all(it % 7 == 0 for it, _ in res.history)
