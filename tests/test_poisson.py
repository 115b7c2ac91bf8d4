"""Problem-generation tests mirroring the reference's Grid tests
(test/testlib.cpp:17-62) plus golden-value checks of the assembled operators
against independent dense numpy construction."""

import numpy as np
import jax.numpy as jnp
import pytest

from amg_jax.models import poisson
from amg_jax.sparse.ell import ELL
from amg_jax.utils.metrics import rss


def dense_laplacian_oracle(n):
    """Independent dense 5-point Laplacian: A = kron(I, D) + kron(D, I)."""
    h = 2.0 / (n + 1)
    D = (np.diag(np.full(n, -2.0)) + np.diag(np.ones(n - 1), 1)
         + np.diag(np.ones(n - 1), -1)) / (h * h)
    I = np.eye(n)
    return np.kron(I, D) + np.kron(D, I)


def test_rhs_size():
    """b.size == n^2 (testlib.cpp:27-28)."""
    n = 2
    b = poisson.rhs(n)
    assert b.shape == (n * n,)


def test_grid_spacing_round_trip():
    """points_n_from_grid_spacing_h(grid_spacing_h(n)) == n
    (testlib.cpp:60-62)."""
    for n in [2, 35, 1023]:
        assert poisson.points_n_from_grid_spacing_h(
            poisson.grid_spacing_h(n)) == n


def test_laplacian_matches_dense_oracle():
    for n in [2, 5, 9]:
        A = poisson.laplacian(n)
        dense = np.asarray(A.to_dense())
        np.testing.assert_allclose(dense, dense_laplacian_oracle(n),
                                   rtol=1e-14)
        # symmetric, 5 nnz max per row
        assert A.row_width == 5 or n == 2
        np.testing.assert_allclose(dense, dense.T)


def test_rhs_traversal_order():
    """b[dof] = f(x_j, x_i) with dof = j*n + i, column-major traversal
    (grid.hpp:127-137)."""
    n = 4
    b = np.asarray(poisson.rhs(n, f=lambda x, y: x + 100 * y))
    dom = np.linspace(-1, 1, n + 2)
    for j in range(n):
        for i in range(n):
            expected = dom[j + 1] + 100 * dom[i + 1]
            np.testing.assert_allclose(b[j * n + i], expected)


def test_rhs_default_forcing_values():
    n = 3
    b = np.asarray(poisson.rhs(n))
    dom = np.linspace(-1, 1, n + 2)
    expected = 5 * np.exp(-10 * (dom[1] ** 2 + dom[2] ** 2))
    np.testing.assert_allclose(b[0 * n + 1], expected)  # j=0 -> x, i=1 -> y


def test_direct_solve_rss_zero():
    """Direct solve of the tiny system has ~0 rss (oracle pattern of
    testlib.cpp:31-38)."""
    n = 2
    A, b = poisson.poisson2d(n)
    u = jnp.linalg.solve(A.to_dense(), b)
    assert float(rss(A, u, b)) < 1e-20


def test_ell_roundtrip_scipy():
    A = poisson.laplacian(7)
    back = A.to_scipy()
    np.testing.assert_allclose(back.toarray(), np.asarray(A.to_dense()))


def test_ell_matvec_matches_dense():
    rng = np.random.default_rng(0)
    A = poisson.laplacian(6)
    x = jnp.asarray(rng.standard_normal(36))
    np.testing.assert_allclose(np.asarray(A.matvec(x)),
                               np.asarray(A.to_dense() @ x), rtol=1e-13)


def test_ell_offdiag_and_diag():
    A = poisson.laplacian(4)
    x = jnp.asarray(np.random.default_rng(1).standard_normal(16))
    off, diag = A.matvec_offdiag_and_diag(x)
    dense = np.asarray(A.to_dense())
    np.testing.assert_allclose(np.asarray(diag), np.diag(dense), rtol=1e-14)
    np.testing.assert_allclose(
        np.asarray(off), (dense - np.diag(np.diag(dense))) @ np.asarray(x),
        rtol=1e-13)


def test_rhs_device_matches_host():
    """On-device RHS generation (zero bulk transfer) agrees with the
    host/reference-parity build to f64 roundoff, at odd and even sizes."""
    for n in (7, 35, 64):
        host = np.asarray(poisson.rhs(n, dtype=jnp.float64))
        dev = np.asarray(poisson.rhs_device(n, dtype=jnp.float64))
        np.testing.assert_allclose(dev, host, rtol=1e-14, atol=0)


def test_rhs_device_f32():
    n = 33
    host = np.asarray(poisson.rhs(n, dtype=jnp.float64), dtype=np.float32)
    dev = np.asarray(poisson.rhs_device(n, dtype=jnp.float32))
    np.testing.assert_allclose(dev, host, rtol=1e-5, atol=0)
