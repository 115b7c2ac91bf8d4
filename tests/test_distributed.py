"""Multi-device tests on the 8-virtual-device CPU mesh: sharded level ops
must agree with single-device results to fp tolerance, and the distributed
solve must converge — the N-host correctness pattern the reference has no
analog of (SURVEY.md §4 implications)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from amg_jax.models import poisson
from amg_jax.parallel.structured_dist import (DistStructuredSolver,
                                              plan_distribution)
from amg_jax.structured import build_stencil_hierarchy, solve_stencil


def test_eight_virtual_devices_available():
    assert len(jax.devices()) >= 8


def test_plan_distribution_invariants():
    sides, blocks, Ls = plan_distribution(31, 4, 8)
    assert sides == (31, 15, 7, 3)
    assert Ls >= 1
    # halving, even blocks; padded rows cover the grid
    for l in range(Ls):
        assert blocks[l] % 2 == 0 or l == Ls - 1
        assert 8 * blocks[l] >= sides[l]
        if l + 1 < Ls:
            assert blocks[l + 1] == blocks[l] // 2


@pytest.mark.parametrize("side", [31, 63])
def test_dist_vcycle_matches_single_device(side):
    """One distributed V-cycle == one single-device V-cycle (same algorithm,
    same numbers up to fp reassociation)."""
    D = 8
    solver = DistStructuredSolver(side, n_devices=D, dtype=jnp.float64)
    n_levels = len(solver.cfg.sides)
    hier = build_stencil_hierarchy(side, n_levels=n_levels,
                                   dtype=jnp.float64)
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)

    b_pad = solver.pad_field(b2)
    u_pad = jnp.zeros_like(b_pad)
    u_dist = solver.unpad(solver.vcycle(u_pad, b_pad))

    from amg_jax.structured import vcycle_stencil
    u_single = vcycle_stencil(hier, jnp.zeros_like(b2), b2)

    np.testing.assert_allclose(np.asarray(u_dist), np.asarray(u_single),
                               rtol=1e-11, atol=1e-13)


def test_dist_solve_converges_and_matches_direct():
    side = 31
    solver = DistStructuredSolver(side, n_devices=8, dtype=jnp.float64)
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    res = solver.solve(b2, tolerance=1e-9, compute_error_every_n_iters=1,
                       n_iters=50)
    assert res.converged
    A = poisson.laplacian_scipy(side)
    u_direct = np.linalg.solve(A.toarray(), np.asarray(b2).reshape(-1))
    np.testing.assert_allclose(np.asarray(res.u).reshape(-1), u_direct,
                               rtol=0, atol=1e-7)


def test_dist_solve_iteration_count_matches_single_device():
    """Same algorithm => same iteration count as the single-device
    structured solver."""
    side = 31
    solver = DistStructuredSolver(side, n_devices=8, dtype=jnp.float64)
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    res_d = solver.solve(b2, tolerance=1e-9, compute_error_every_n_iters=1,
                         n_iters=50)
    hier = build_stencil_hierarchy(side, n_levels=len(solver.cfg.sides),
                                   dtype=jnp.float64)
    res_s = solve_stencil(hier, b2, tolerance=1e-9,
                          compute_error_every_n_iters=1, n_iters=50)
    assert res_d.iterations == res_s.iterations


def test_dist_various_device_counts():
    """Works for 1, 2, 4 devices too (padding/agglomeration paths)."""
    side = 31
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    results = []
    for D in (1, 2, 4):
        solver = DistStructuredSolver(side, n_devices=D, dtype=jnp.float64)
        res = solver.solve(b2, tolerance=1e-9,
                           compute_error_every_n_iters=1, n_iters=50)
        assert res.converged, f"D={D}"
        results.append(np.asarray(res.u))
    np.testing.assert_allclose(results[0], results[1], rtol=1e-10)
    np.testing.assert_allclose(results[0], results[2], rtol=1e-10)


def test_dist_ghost_sweep_matches_per_step_halo():
    """The one-exchange-per-sweep ghost-strip path must produce the same
    iterate as the reference-style exchange-before-every-color-step path
    (both equal the global masked sweep)."""
    side = 63
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    s_ghost = DistStructuredSolver(side, n_devices=8, dtype=jnp.float64,
                                   halo="sweep")
    s_step = DistStructuredSolver(side, n_devices=8, dtype=jnp.float64,
                                  halo="step", force_var=True)
    assert all(w is not None for w in s_ghost.cfg.w33s)
    assert all(w is None for w in s_step.cfg.w33s)
    bg = s_ghost.pad_field(b2)
    bs = s_step.pad_field(b2)
    ug = s_ghost.unpad(s_ghost.vcycle(jnp.zeros_like(bg), bg))
    us = s_step.unpad(s_step.vcycle(jnp.zeros_like(bs), bs))
    np.testing.assert_allclose(np.asarray(ug), np.asarray(us),
                               rtol=1e-12, atol=1e-14)


def test_dist_overlap_halo_bitwise_matches_ghost_sweep():
    """The compute-overlapped halo restructuring must not change a single
    bit: interior rows never needed neighbor data, boundary bands do the
    identical arithmetic on identical values."""
    side = 127
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    us = {}
    for halo in ("sweep", "overlap"):
        s = DistStructuredSolver(side, n_devices=8, dtype=jnp.float64,
                                 halo=halo)
        bp = s.pad_field(b2)
        us[halo] = np.asarray(s.unpad(s.vcycle(jnp.zeros_like(bp), bp)))
    np.testing.assert_array_equal(us["sweep"], us["overlap"])


def test_dist_ghost_path_uses_fewer_collectives():
    """The ghost-strip V-cycle must lower to strictly fewer ppermutes than
    the per-color-step variant."""
    side = 63
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    counts = {}
    for name, kw in [("sweep", dict(halo="sweep")),
                     ("step", dict(halo="step", force_var=True))]:
        s = DistStructuredSolver(side, n_devices=8, dtype=jnp.float64, **kw)
        bp = s.pad_field(b2)
        hlo = s._vcycle.lower(s.coeffs, s.sub_hier, jnp.zeros_like(bp),
                              bp).compile().as_text()
        counts[name] = hlo.count("collective-permute(")
    assert counts["sweep"] < counts["step"] / 2, counts


def test_dist_solve_ir_reaches_reference_tolerance():
    """Distributed df32 defect correction hits the reference's 1e-9-grade
    rss (testlib.cpp:158) and matches the single-chip mixed-precision
    solve."""
    from amg_jax.structured import StructuredSolver

    side = 63
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    s = DistStructuredSolver(side, n_devices=8)
    res = s.solve_ir(b2, tolerance=1e-9)
    assert res.converged and res.error <= 1e-9
    ss = StructuredSolver(side, precision="f64", device_setup=False)
    r2 = ss.solve_ir(b2, tolerance=1e-9)
    assert res.iterations == r2.iterations
    np.testing.assert_allclose(np.asarray(res.u), np.asarray(r2.u),
                               rtol=0, atol=1e-10)


def test_dist_vcycle_hlo_contains_expected_collectives():
    """Structural check (SNIPPETS.md [2] HLO-inspection pattern): the
    sharded V-cycle lowers to ppermute halo exchanges and an all-gather
    agglomeration, with psum only in the rss program."""
    side = 31
    solver = DistStructuredSolver(side, n_devices=8, dtype=jnp.float64)
    b_pad = solver.pad_field(
        poisson.rhs(side, dtype=jnp.float64).reshape(side, side))
    u = jnp.zeros_like(b_pad)
    hlo = solver._vcycle.lower(solver.coeffs, solver.sub_hier, u,
                               b_pad).compile().as_text()
    assert "collective-permute" in hlo
    assert "all-gather" in hlo
    rss_hlo = solver._rss.lower(solver.coeffs[0], u, b_pad
                                ).compile().as_text()
    assert "all-reduce" in rss_hlo


def test_dist_solve_ir_device_matches_host_loop():
    """The one-dispatch while_loop solve (collectives inside the loop) must
    reach the same tolerance as the host-stepped refine loop; the lagged
    error may run it one refinement further."""
    side = 63
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    s = DistStructuredSolver(side, n_devices=8)
    res_host = s.solve_ir(b2, tolerance=1e-9)
    res_dev = s.solve_ir_fused(b2, tolerance=1e-9)
    assert res_dev.converged and res_dev.error <= 1e-9
    assert abs(res_dev.iterations - res_host.iterations) <= \
        2 * s.cycles_per_refine
    np.testing.assert_allclose(np.asarray(res_dev.u),
                               np.asarray(res_host.u), rtol=0, atol=1e-9)


def test_dist_packed_halo_matches_ghost_sweep():
    """The color-packed distributed sweep (the distributed form of the
    production single-chip smoother) must reproduce the full-width
    ghost-sweep V-cycle to fp-reassociation tolerance, and its df32 solve
    must converge."""
    side = 63
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    us = {}
    for halo in ("sweep", "packed"):
        s = DistStructuredSolver(side, n_devices=8, dtype=jnp.float64,
                                 halo=halo)
        bp = s.pad_field(b2)
        us[halo] = np.asarray(s.unpad(s.vcycle(jnp.zeros_like(bp), bp)))
    np.testing.assert_allclose(us["packed"], us["sweep"],
                               rtol=1e-12, atol=1e-13)

    s32 = DistStructuredSolver(side, n_devices=8, halo="packed")
    res = s32.solve_ir(b2, tolerance=1e-9)
    assert res.converged and res.error <= 1e-9


def test_dist_var_ghost_sweep_matches_per_step_halo():
    """variable-coefficient levels must take the
    ghost-strip path too (coefficient-plane strips exchanged once,
    loop-invariant) — bitwise-equal iterates to the per-color-step
    exchange, for both 'sweep' and 'overlap' modes."""
    side = 63
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    us = {}
    for halo in ("step", "sweep", "overlap"):
        s = DistStructuredSolver(side, n_devices=8, dtype=jnp.float64,
                                 halo=halo, force_var=True)
        assert all(w is None for w in s.cfg.w33s)
        bp = s.pad_field(b2)
        us[halo] = np.asarray(s.unpad(s.vcycle(jnp.zeros_like(bp), bp)))
    np.testing.assert_array_equal(us["sweep"], us["step"])
    np.testing.assert_array_equal(us["overlap"], us["step"])


def test_dist_var_ghost_path_uses_fewer_collectives():
    """The var ghost-strip V-cycle must lower to strictly fewer ppermutes
    than the per-color-step variant: the (u, b) strip rides one exchange
    per sweep and the coefficient-plane exchange is loop-invariant."""
    side = 63
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    counts = {}
    for name, halo in [("sweep", "sweep"), ("step", "step")]:
        s = DistStructuredSolver(side, n_devices=8, dtype=jnp.float64,
                                 halo=halo, force_var=True)
        bp = s.pad_field(b2)
        hlo = s._vcycle.lower(s.coeffs, s.sub_hier, jnp.zeros_like(bp),
                              bp).compile().as_text()
        counts[name] = hlo.count("collective-permute(")
    assert counts["sweep"] < counts["step"] / 2, counts


def test_dist_var_ghost_solve_converges():
    side = 63
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    s = DistStructuredSolver(side, n_devices=8, dtype=jnp.float64,
                             halo="sweep", force_var=True)
    res = s.solve(b2, tolerance=1e-9)
    assert res.converged and res.error <= 1e-9


def test_dist_pcg_matches_single_device():
    """Distributed device-resident PCG (psum'd inner products,
    preconditioned by the shard_map V-cycle) reproduces the single-device
    PCG: same iteration count, same iterates to fp-reassociation
    tolerance."""
    from amg_jax.krylov import solve_pcg_stencil

    side = 31
    solver = DistStructuredSolver(side, n_devices=8, dtype=jnp.float64)
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    res_d = solver.solve_pcg(b2, tolerance=1e-9, n_iters=50)
    hier = build_stencil_hierarchy(side, n_levels=len(solver.cfg.sides),
                                   dtype=jnp.float64)
    res_s = solve_pcg_stencil(hier, b2, tolerance=1e-9, n_iters=50)
    assert res_d.converged and res_s.converged
    assert res_d.iterations == res_s.iterations, (
        f"dist {res_d.iterations} vs single {res_s.iterations}")
    scale = float(np.abs(np.asarray(res_s.u)).max())
    np.testing.assert_allclose(np.asarray(res_d.u), np.asarray(res_s.u),
                               rtol=0, atol=1e-10 * scale)


def test_dist_pcg_var_coefficient_converges():
    """PCG over the variable-coefficient (force_var) distributed path:
    plane-based matvec + var ghost-strip preconditioner."""
    side = 31
    solver = DistStructuredSolver(side, n_devices=4, dtype=jnp.float64,
                                  force_var=True)
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    res = solver.solve_pcg(b2, tolerance=1e-9, n_iters=50)
    assert res.converged, f"rss={res.error:.3e}"


def test_dist_pcg_step_halo_converges():
    side = 31
    solver = DistStructuredSolver(side, n_devices=8, dtype=jnp.float64,
                                  halo="step")
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    res = solver.solve_pcg(b2, tolerance=1e-9, n_iters=50)
    assert res.converged, f"rss={res.error:.3e}"
