"""Device-side ELL Galerkin RAP (ops/ell_rap): the jitted SpGEMM analog of
the reference's host Eigen products (multigrid.hpp:219-223), exploiting the
fixed 3-nnz/column transfer structure (interpolator.hpp:98-142)."""

import numpy as np
import jax.numpy as jnp
import pytest

from amg_jax.models import poisson
from amg_jax.multigrid import (build_hierarchy, build_hierarchy_device,
                               rebuild_hierarchy_values, solve)
from amg_jax.ops.ell_rap import apply_rap_chain, build_rap_plans
from amg_jax.ops.smoothers import MulticolorGaussSeidel
from amg_jax.ops.transfer import LinearInterpolator
from amg_jax.sparse.ell import ELL


def _scipy_chain(A_sp, n_levels):
    interp = LinearInterpolator(n_levels)
    mats = [A_sp.tocsr()]
    for _ in range(n_levels - 1):
        n_h = mats[-1].shape[0]
        n_H = interp.coarse_size(n_h)
        P, R = interp.make_operators_scipy(n_h, n_H)
        mats.append((R @ (mats[-1] @ P)).tocsr())
    return mats


@pytest.mark.parametrize("n,n_levels", [(35, 8), (20, 4)])
def test_device_rap_matches_scipy_chain(n, n_levels):
    A_ell, _ = poisson.poisson2d(n)
    ref = _scipy_chain(A_ell.to_scipy(), n_levels)
    plans, mats = build_rap_plans(A_ell, n_levels)
    for l in range(1, n_levels):
        diff = abs(mats[l].to_scipy() - ref[l]).max()
        scale = abs(ref[l]).max()
        # accumulation order differs from scipy's SpGEMM; equality is
        # bitwise on the 2^k-1 grids and ~1 ulp otherwise
        assert diff <= 1e-14 * scale, f"level {l}: maxdiff {diff}"


def test_jitted_chain_scales_linearly():
    """Value-only rebuild is exact for scaled coefficients (the
    coefficient-update use case, BASELINE config 4)."""
    A_ell, _ = poisson.poisson2d(20)
    plans, mats = build_rap_plans(A_ell, 4)
    datas = apply_rap_chain(tuple(plans), A_ell.data * 3.0)
    for l in range(1, 4):
        got = ELL(data=datas[l], cols=mats[l].cols,
                  shape=mats[l].shape).to_scipy()
        want = 3.0 * mats[l].to_scipy()
        assert abs(got - want).max() < 1e-12


def test_device_hierarchy_solves_to_reference_tolerance():
    A_ell, b = poisson.poisson2d(35)
    hier, plans = build_hierarchy_device(A_ell, 8)
    sm = MulticolorGaussSeidel()
    res = solve(hier, sm, b, tolerance=1e-9,
                compute_error_every_n_iters=5, n_iters=100)
    assert res.converged and res.error < 1e-9


def test_rebuild_values_matches_fresh_build():
    """Refreshing values on device == rebuilding from scratch with the
    scaled operator (same pattern)."""
    A_ell, b = poisson.poisson2d(20)
    sm = MulticolorGaussSeidel()
    hier, plans = build_hierarchy_device(A_ell, 4, smoother=sm)
    scaled = ELL(data=A_ell.data * 2.5, cols=A_ell.cols, shape=A_ell.shape)
    hier2 = rebuild_hierarchy_values(hier, plans, scaled.data)
    fresh, _ = build_hierarchy_device(scaled, 4, smoother=sm)
    for l in range(4):
        np.testing.assert_allclose(np.asarray(hier2.levels[l].A.data),
                                   np.asarray(fresh.levels[l].A.data),
                                   rtol=0, atol=1e-13)
    u2 = vstep(hier2, sm, b)
    uf = vstep(fresh, sm, b)
    np.testing.assert_allclose(np.asarray(u2), np.asarray(uf),
                               rtol=1e-12, atol=1e-14)


def vstep(hier, sm, b):
    from amg_jax.multigrid import vcycle

    return vcycle(hier, sm, jnp.zeros_like(b), b)
