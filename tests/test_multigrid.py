"""Multigrid integration tests mirroring the reference end-to-end suite
(test/testlib.cpp:130-213), including the headline parity case: the
1225-dof / 8-level Poisson problem converging in 35 V-cycles to
rss ~ 7.2e-11 (image/README/output.png; BASELINE.md)."""

import numpy as np
import jax.numpy as jnp
import pytest

from amg_jax.models import poisson
from amg_jax.multigrid import Multigrid, build_hierarchy, solve, vcycle
from amg_jax.ops.smoothers import (MulticolorGaussSeidel, SparseGaussSeidel)
from amg_jax.ops.transfer import BilinearInterpolator2D, LinearInterpolator
from amg_jax.utils.metrics import rss


def test_invalid_every_gt_niters_raises():
    """Multigrid throws when compute_error_every_n_iters > n_iters
    (testlib.cpp:130-136, multigrid.hpp:164-169)."""
    A, b = poisson.poisson2d(2)
    with pytest.raises(ValueError):
        Multigrid(None, None, A, b, 8, 1e-9, 100, 10)


def test_invalid_dof_mismatch_raises():
    """Multigrid throws on A/b dof mismatch (testlib.cpp:138-144,
    multigrid.hpp:171-178)."""
    A, _ = poisson.poisson2d(3)
    bad_b = jnp.zeros(11)
    with pytest.raises(ValueError):
        Multigrid(None, None, A, bad_b, 8, 1e-9, 5, 10)


def test_hierarchy_monotone_coarsening():
    """Every coarser level has strictly smaller A/u/b (testlib.cpp:161-181)
    and the reference dof sequence 1225..8 (image/README/output.png)."""
    n = 35
    A, b = poisson.poisson2d(n)
    amg = Multigrid(None, None, A, b, 8, 1e-9, 5, 100)
    dofs = [amg.get_n_dofs(l) for l in range(8)]
    assert dofs == [1225, 612, 305, 152, 75, 37, 18, 8]
    for level in range(1, 8):
        finer_A = amg.get_coefficient_matrix(level - 1)
        coarser_A = amg.get_coefficient_matrix(level)
        assert finer_A.n_rows > coarser_A.n_rows
        assert amg.get_soln(level - 1).shape[0] > amg.get_soln(level).shape[0]
        assert amg.get_rhs(level - 1).shape[0] > amg.get_rhs(level).shape[0]


@pytest.mark.slow
def test_standalone_spgs_converges_900_iters():
    """Standalone symmetric GS on the 1225-dof problem: rss < 1e-9 within
    1000 iterations — the reference converges in exactly 900
    (testlib.cpp:183-196, image/README/output.png)."""
    n = 35
    A, b = poisson.poisson2d(n)
    sm = SparseGaussSeidel(tolerance=1e-9, compute_error_every_n_iters=100,
                           n_iters=1000)
    res = sm.smooth(A, jnp.zeros_like(b), b)
    assert res.converged
    assert res.iterations == 900
    assert res.error < 1e-9


@pytest.mark.slow
def test_amg_parity_35_vcycles():
    """The headline reference benchmark (testlib.cpp:147-213): 8-level AMG
    with symmetric sequential GS smoothing, tol 1e-9 checked every 5 cycles,
    converges in 35 V-cycles with final rss ~ 7.19e-11."""
    n = 35
    A, b = poisson.poisson2d(n)
    amg = Multigrid(LinearInterpolator(8), SparseGaussSeidel(), A, b, 8,
                    1e-9, 5, 100)
    res = amg.solve(verbose=False)
    assert res.converged
    assert res.iterations == 35
    assert res.error < 1e-9
    # reference final rss 7.19199e-11; allow slack for fp-order differences
    assert res.error == pytest.approx(7.19199e-11, rel=1e-3)


@pytest.mark.slow
def test_amg_matches_standalone_spgs():
    """AMG solution isApprox-matches the standalone GS solution at 1e-6
    (testlib.cpp:208-212)."""
    n = 35
    A, b = poisson.poisson2d(n)
    amg = Multigrid(None, None, A, b, 8, 1e-9, 5, 100)
    res = amg.solve(verbose=False)
    sm = SparseGaussSeidel(tolerance=1e-9, compute_error_every_n_iters=100,
                           n_iters=1000)
    gs = sm.smooth(A, jnp.zeros_like(b), b)
    # Eigen isApprox(x, tol): ||x - y|| <= tol * min(||x||, ||y||)
    diff = np.linalg.norm(np.asarray(res.u) - np.asarray(gs.u))
    scale = min(np.linalg.norm(np.asarray(res.u)),
                np.linalg.norm(np.asarray(gs.u)))
    assert diff <= 1e-6 * scale


def test_vcycle_reduces_error_small():
    """Single V-cycle strictly reduces rss on a small problem."""
    n = 9
    A, b = poisson.poisson2d(n)
    sm = SparseGaussSeidel()
    hier = build_hierarchy(A, 3, LinearInterpolator(3), sm)
    u0 = jnp.zeros_like(b)
    e0 = float(rss(A, u0, b))
    u1 = vcycle(hier, sm, u0, b)
    e1 = float(rss(A, u1, b))
    assert e1 < e0 * 1e-1


def test_multicolor_smoother_amg_converges():
    """Production multicolor smoother converges (possibly different
    iteration count than lexicographic — documented, SURVEY.md §7)."""
    n = 35
    A, b = poisson.poisson2d(n)
    amg = Multigrid(None, MulticolorGaussSeidel(), A, b, 8, 1e-9, 5, 100)
    res = amg.solve(verbose=False)
    assert res.converged
    assert res.error < 1e-9


def test_bilinear_2d_path_converges_fast():
    """Extension path: 2-D bilinear transfer converges in far fewer cycles
    (textbook multigrid efficiency)."""
    side = 31
    A, b = poisson.poisson2d(side)
    interp = BilinearInterpolator2D(fine_side=side)
    amg = Multigrid(interp, MulticolorGaussSeidel(), A, b, 4, 1e-9, 1, 100)
    res = amg.solve(verbose=False)
    assert res.converged
    assert res.iterations <= 12


def test_solver_state_getters():
    """Stateful vcycle updates per-level soln/rhs/residual mirrors
    (multigrid.hpp:263-305 in-place semantics)."""
    n = 9
    A, b = poisson.poisson2d(n)
    amg = Multigrid(None, None, A, b, 3, 1e-9, 5, 100)
    assert float(jnp.sum(jnp.abs(amg.get_soln(0)))) == 0
    np.testing.assert_allclose(np.asarray(amg.get_rhs(0)), np.asarray(b))
    amg.vcycle()
    assert float(jnp.sum(jnp.abs(amg.get_soln(0)))) > 0
    assert float(jnp.sum(jnp.abs(amg.get_rhs(1)))) > 0


def test_display_error_toggles():
    n = 9
    A, b = poisson.poisson2d(n)
    amg = Multigrid(None, None, A, b, 3, 1e-9, 5, 100)
    amg.display_error_on()
    assert amg._display_error
    amg.display_error_off()  # reference bug fixed (multigrid.hpp:361-364)
    assert not amg._display_error
