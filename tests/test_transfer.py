"""Grid-transfer tests: golden P stencil patterns (replacing the reference's
print-only inspection, test/testlib.cpp:117-128) and Galerkin RAP checks."""

import numpy as np
import jax.numpy as jnp

from amg_jax.models import poisson
from amg_jax.multigrid import galerkin_rap, n_H_dofs_from_n_h_dofs
from amg_jax.ops.transfer import (BilinearInterpolator2D, LinearInterpolator,
                                  linear_interp_1d)


def golden_P(n_h, n_H):
    """Dense oracle of the reference P construction
    (interpolator.hpp:114-129): column j has [0.5, 1.0, 0.5] at rows
    2j, 2j+1, 2j+2, out-of-range rows dropped."""
    P = np.zeros((n_h, n_H))
    for j in range(n_H):
        for off, v in ((0, 0.5), (1, 1.0), (2, 0.5)):
            if 2 * j + off < n_h:
                P[2 * j + off, j] = v
    return P


def test_linear_interpolator_golden_7_3():
    """The (n_h=7, n_H=3) case the reference prints (testlib.cpp:121-123)."""
    interp = LinearInterpolator()
    P, R = interp.make_operators_scipy(7, 3)
    np.testing.assert_allclose(P.toarray(), golden_P(7, 3))
    np.testing.assert_allclose(R.toarray(), golden_P(7, 3).T)


def test_linear_interpolator_golden_24_11_bounds_drop():
    """(n_h=24, n_H=11): trailing fine row 23 is all-zero because 2*11+... is
    out of range — bounds-check drop behavior (interpolator.hpp:114-129)."""
    interp = LinearInterpolator()
    P, R = interp.make_operators_scipy(24, 11)
    G = golden_P(24, 11)
    np.testing.assert_allclose(P.toarray(), G)
    assert np.all(G[23] == 0)  # dropped row
    # R = P^T exactly, no full-weighting scale (interpolator.hpp:131-134)
    np.testing.assert_allclose(R.toarray(), G.T)


def test_coarse_size_formula():
    """n_H = (n_h+1)/2 - 1 (multigrid.hpp:127-130); reference level dof
    sequence 1225 -> 612 -> 305 -> 152 -> 75 -> 37 -> 18 -> 8."""
    seq = [1225]
    for _ in range(7):
        seq.append(n_H_dofs_from_n_h_dofs(seq[-1]))
    assert seq == [1225, 612, 305, 152, 75, 37, 18, 8]
    interp = LinearInterpolator()
    assert interp.coarse_size(1225) == 612


def test_make_operators_ell_application():
    """ELL P/R application matches dense mat-vec (interpolator.hpp:52-68)."""
    interp = LinearInterpolator(n_levels=3)
    interp.make_operators(24, 11, 0)
    v = jnp.asarray(np.random.default_rng(0).standard_normal(11))
    out = interp.prolongation(v, 0)
    np.testing.assert_allclose(np.asarray(out), golden_P(24, 11) @ np.asarray(v),
                               rtol=1e-13)
    w = jnp.asarray(np.random.default_rng(1).standard_normal(24))
    np.testing.assert_allclose(np.asarray(interp.restriction(w, 0)),
                               golden_P(24, 11).T @ np.asarray(w), rtol=1e-13)


def test_galerkin_rap_matches_dense():
    """A_H = R (A P) equals the dense triple product (multigrid.hpp:219-223)."""
    n = 5
    A = poisson.laplacian_scipy(n)
    interp = LinearInterpolator()
    n_h = n * n
    n_H = interp.coarse_size(n_h)
    P, R = interp.make_operators_scipy(n_h, n_H)
    A_H = galerkin_rap(R, A, P)
    dense = golden_P(n_h, n_H).T @ A.toarray() @ golden_P(n_h, n_H)
    np.testing.assert_allclose(A_H.toarray(), dense, rtol=1e-12)


def test_linear_interp_1d_full_range():
    P = linear_interp_1d(7, 3)
    np.testing.assert_allclose(P.toarray(), golden_P(7, 3))


def test_bilinear_2d_kron_structure_and_9point_closure():
    """P2d = kron(P1, P1); Galerkin RAP of the 5-point Laplacian is a 9-point
    stencil at every level (extension path)."""
    side = 7
    interp = BilinearInterpolator2D(fine_side=side)
    n_h = side * side
    n_H = interp.coarse_size(n_h)
    assert n_H == 9  # side 3
    P, R = interp.make_operators_scipy(n_h, n_H)
    P1 = linear_interp_1d(7, 3).toarray()
    np.testing.assert_allclose(P.toarray(), np.kron(P1, P1))
    A = poisson.laplacian_scipy(side)
    A_H = galerkin_rap(R, A, P)
    # 9-point: each coarse row couples only to grid-neighbor coarse dofs
    A_H = A_H.tocsr()
    side_c = 3
    for i in range(n_H):
        ci, cj = i % side_c, i // side_c
        for j in A_H[i].indices:
            di = abs(j % side_c - ci)
            dj = abs(j // side_c - cj)
            assert di <= 1 and dj <= 1
