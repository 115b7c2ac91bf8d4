"""Structured stencil-path tests: operator equivalence against the
unstructured scipy/ELL oracle, four-color sweep correctness, transfer
equivalence with kron(P1,P1), and end-to-end structured V-cycle convergence."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp

from amg_jax.models import poisson
from amg_jax.ops.transfer import linear_interp_1d
from amg_jax.sparse.stencil import (Stencil2D, gs4_sweep, prolong,
                                    restrict_fw)
from amg_jax.structured import (build_stencil_hierarchy, max_levels_for_side,
                                solve_ir, solve_stencil, vcycle_stencil)
from amg_jax.utils.coloring import four_color_2d


def test_stencil_from_scipy_roundtrip():
    n = 7
    A = poisson.laplacian_scipy(n)
    S = Stencil2D.from_scipy(A, n)
    np.testing.assert_allclose(S.to_scipy().toarray(), A.toarray())


def test_stencil_matvec_matches_scipy():
    n = 9
    A = poisson.laplacian_scipy(n)
    S = Stencil2D.from_scipy(A, n)
    rng = np.random.default_rng(0)
    u = rng.standard_normal(n * n)
    np.testing.assert_allclose(np.asarray(S.matvec(jnp.asarray(u))), A @ u,
                               rtol=1e-13)


def test_stencil_matvec_galerkin_level():
    """9-point Galerkin level matvec matches scipy."""
    n = 7
    A = poisson.laplacian_scipy(n)
    P1 = linear_interp_1d(7, 3)
    P = sp.kron(P1, P1).tocsr()
    A_H = (P.T @ (A @ P)).tocsr()
    S = Stencil2D.from_scipy(A_H, 3)
    rng = np.random.default_rng(1)
    u = rng.standard_normal(9)
    np.testing.assert_allclose(np.asarray(S.matvec(jnp.asarray(u))), A_H @ u,
                               rtol=1e-12)


def test_gs4_sweep_matches_color_ordered_sequential():
    """Four-color structured sweep equals sequential GS visited in
    four-color order (dense oracle)."""
    n = 5
    A = poisson.laplacian_scipy(n)
    S = Stencil2D.from_scipy(A, n)
    dense = A.toarray()
    b = np.asarray(poisson.rhs(n))
    rng = np.random.default_rng(2)
    u = rng.standard_normal(n * n)
    # copy: jnp.asarray may zero-copy the numpy buffer on CPU, and the
    # oracle loop below mutates u in place
    u0 = jnp.array(u.reshape(n, n).copy())

    colors = four_color_2d(n)
    order = np.concatenate([np.nonzero(colors == c)[0] for c in range(4)])
    for i in order:
        s = dense[i] @ u - dense[i, i] * u[i]
        u[i] = (b[i] - s) / dense[i, i]

    out = gs4_sweep(S, u0, jnp.asarray(b.reshape(n, n)), symmetric=False)
    np.testing.assert_allclose(np.asarray(out).reshape(-1), u, rtol=1e-12)


def test_restrict_matches_kron_P():
    nf, nc = 9, 4
    P1 = linear_interp_1d(nf, nc)
    P = sp.kron(P1, P1)
    rng = np.random.default_rng(3)
    r = rng.standard_normal(nf * nf)
    expect = (P.T @ r).reshape(nc, nc)
    got = restrict_fw(jnp.asarray(r.reshape(nf, nf)))
    np.testing.assert_allclose(np.asarray(got), expect, rtol=1e-13)


def test_prolong_matches_kron_P():
    nf, nc = 9, 4
    P1 = linear_interp_1d(nf, nc)
    P = sp.kron(P1, P1)
    rng = np.random.default_rng(4)
    uc = rng.standard_normal(nc * nc)
    expect = (P @ uc).reshape(nf, nf)
    got = prolong(jnp.asarray(uc.reshape(nc, nc)), nf)
    np.testing.assert_allclose(np.asarray(got), expect, rtol=1e-13)


def test_max_levels():
    assert max_levels_for_side(31) == 4   # 31 -> 15 -> 7 -> 3
    assert max_levels_for_side(1023) == 9


def test_structured_vcycle_converges_f64():
    side = 31
    hier = build_stencil_hierarchy(side, dtype=jnp.float64)
    b2 = poisson.rhs(side).reshape(side, side)
    res = solve_stencil(hier, b2, tolerance=1e-9, n_iters=100,
                        compute_error_every_n_iters=1)
    assert res.converged
    assert res.iterations <= 12  # textbook multigrid efficiency
    # solution matches dense direct solve
    A = poisson.laplacian_scipy(side)
    u_direct = np.linalg.solve(A.toarray(), np.asarray(b2).reshape(-1))
    np.testing.assert_allclose(np.asarray(res.u).reshape(-1), u_direct,
                               rtol=0, atol=1e-7)


def test_structured_ir_reaches_f64_tolerance():
    """f32 V-cycles + f64 defect correction reach rss < 1e-9."""
    side = 31
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    res = solve_ir(side, b2, tolerance=1e-9)
    assert res.converged
    assert res.error < 1e-9


def test_device_rap_matches_scipy():
    """Closed-form on-device Galerkin RAP equals host scipy R@(A@P)."""
    from amg_jax.ops.rap import rap_stencil_planes

    for side in (7, 15, 31):
        A = poisson.laplacian_scipy(side)
        S = Stencil2D.from_scipy(A, side, dtype=jnp.float64)
        nc = (side - 1) // 2
        P1 = linear_interp_1d(side, nc)
        P = sp.kron(P1, P1).tocsr()
        A_H = (P.T @ (A @ P)).tocsr()
        want = Stencil2D.from_scipy(A_H, nc, dtype=jnp.float64)
        got = rap_stencil_planes(S.c.reshape(3, 3, side, side))
        np.testing.assert_allclose(np.asarray(got), np.asarray(want.c),
                                   rtol=1e-12, atol=1e-14)


def test_device_rap_two_levels():
    from amg_jax.ops.rap import build_hierarchy_planes

    side = 15
    A = poisson.laplacian_scipy(side)
    S = Stencil2D.from_scipy(A, side, dtype=jnp.float64)
    planes = build_hierarchy_planes(S.c, 3)
    # compare level 2 against host chain
    mats = [A]
    s = side
    for _ in range(2):
        nc = (s - 1) // 2
        P1 = linear_interp_1d(s, nc)
        P = sp.kron(P1, P1).tocsr()
        mats.append((P.T @ (mats[-1] @ P)).tocsr())
        s = nc
    want = Stencil2D.from_scipy(mats[2], 3, dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(planes[2]), np.asarray(want.c),
                               rtol=1e-12, atol=1e-14)


def test_structured_solver_object():
    from amg_jax.structured import StructuredSolver

    side = 31
    solver = StructuredSolver(side)
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    res = solver.solve_ir(b2, tolerance=1e-9)
    assert res.converged and res.error < 1e-9
    res2 = solver.solve_ir(b2, tolerance=1e-9)
    assert res2.iterations == res.iterations


def test_structured_solver_fused_loop():
    from amg_jax.structured import StructuredSolver

    side = 31
    solver = StructuredSolver(side)
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    res = solver.solve_ir_fused(b2, tolerance=1e-9)
    assert res.converged and res.error < 1e-9
    # both paths converge to the direct solution (they may stop at
    # different refinement counts, so compare to the oracle, not each other)
    A = poisson.laplacian_scipy(side)
    u_direct = np.linalg.solve(A.toarray(), np.asarray(b2).reshape(-1))
    np.testing.assert_allclose(np.asarray(res.u).reshape(-1), u_direct,
                               rtol=0, atol=1e-7)


def test_device_hierarchy_matches_host():
    """On-device hierarchy build == host scipy build (f64)."""
    from amg_jax.structured import build_stencil_hierarchy_device

    side = 31
    host = build_stencil_hierarchy(side, dtype=jnp.float64)
    dev = build_stencil_hierarchy_device(side, dtype=jnp.float64)
    assert dev.sides == host.sides
    # device levels are plane-free (Stencil2D.const): compare the static
    # weights against the host build's detected ones, and one densified
    # level exactly
    from amg_jax.sparse.stencil import const_planes

    for a, b in zip(dev.levels, host.levels):
        assert a.w33 is not None and b.w33 is not None
        np.testing.assert_allclose(np.asarray(a.w33), np.asarray(b.w33),
                                   rtol=1e-12, atol=1e-14)
        assert a.c.shape == (3, 3, 0, 0)  # no materialized planes
    np.testing.assert_allclose(
        np.asarray(const_planes(dev.levels[1].w33, dev.sides[1],
                                jnp.float64)),
        np.asarray(host.levels[1].c), rtol=1e-12, atol=1e-12)
    for a, b in zip(dev.P1s, host.P1s):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    r1 = solve_stencil(dev, b2, tolerance=1e-9,
                       compute_error_every_n_iters=1)
    r2 = solve_stencil(host, b2, tolerance=1e-9,
                       compute_error_every_n_iters=1)
    assert r1.converged and r1.iterations == r2.iterations


def test_wcycle_matches_vcycle_semantics_and_converges():
    """gamma=1 cycle == vcycle; gamma=2 (W-cycle) converges at least as
    fast per iteration."""
    from amg_jax.structured import cycle_stencil

    side = 31
    hier = build_stencil_hierarchy(side, dtype=jnp.float64)
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    u0 = jnp.zeros_like(b2)
    v1 = vcycle_stencil(hier, u0, b2)
    c1 = cycle_stencil(hier, u0, b2, gamma=1)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(c1), rtol=1e-14)

    from amg_jax.utils.metrics import rss_from_residual
    S = hier.levels[0]
    w1 = cycle_stencil(hier, u0, b2, gamma=2)
    ev = float(rss_from_residual(b2 - S.matvec2(v1)))
    ew = float(rss_from_residual(b2 - S.matvec2(w1)))
    assert ew <= ev * 1.5  # W-cycle at least comparable per iteration


def test_fmg_start_discretization_accurate():
    """One FMG pass lands far closer than a zero guess + one V-cycle."""
    from amg_jax.structured import fmg_stencil
    from amg_jax.utils.metrics import rss_from_residual

    side = 63
    hier = build_stencil_hierarchy(side, dtype=jnp.float64)
    b2 = poisson.rhs(side).reshape(side, side)
    u_fmg = fmg_stencil(hier, b2)
    rss_fmg = float(rss_from_residual(b2 - hier.levels[0].matvec2(u_fmg)))
    u_v = vcycle_stencil(hier, jnp.zeros_like(b2), b2)
    rss_v = float(rss_from_residual(b2 - hier.levels[0].matvec2(u_v)))
    assert rss_fmg < rss_v / 5


def test_fmg_solver_converges_fewer_refines():
    from amg_jax.structured import StructuredSolver

    side = 31
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    s_fmg = StructuredSolver(side, fmg=True)
    s_zero = StructuredSolver(side, fmg=False)
    r1 = s_fmg.solve_ir_fused(b2, tolerance=1e-9)
    r0 = s_zero.solve_ir_fused(b2, tolerance=1e-9)
    assert r1.converged and r0.converged
    assert r1.iterations <= r0.iterations
    A = poisson.laplacian_scipy(side)
    u_direct = np.linalg.solve(A.toarray(), np.asarray(b2).reshape(-1))
    np.testing.assert_allclose(np.asarray(r1.u).reshape(-1), u_direct,
                               rtol=0, atol=1e-7)


def test_chebyshev_smoother_converges_faster_per_cycle():
    """Chebyshev(4) V-cycles (PAPERS.md polynomial-smoother extension) must
    converge in no more cycles than symmetric four-color GS at half the
    smoothing passes per cycle."""
    import jax.numpy as jnp
    from amg_jax.models import poisson
    from amg_jax.structured import build_stencil_hierarchy, solve_stencil

    side = 63
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    iters = {}
    for sm in ("masked", "chebyshev"):
        hier = build_stencil_hierarchy(side, dtype=jnp.float64, smoother=sm)
        res = solve_stencil(hier, b2, tolerance=1e-9,
                            compute_error_every_n_iters=1)
        assert res.converged, sm
        iters[sm] = res.iterations
    assert iters["chebyshev"] <= iters["masked"], iters


def test_const_lam_max_bounds_spectrum():
    """The analytic Fourier-corner bound dominates the true spectral radius
    of D^-1 A on every level (dense eigenvalues, small case)."""
    import numpy as np
    import jax.numpy as jnp
    from amg_jax.structured import build_stencil_hierarchy
    from amg_jax.sparse.stencil import const_lam_max

    hier = build_stencil_hierarchy(31, dtype=jnp.float64)
    for S in hier.levels:
        A = S.to_scipy().toarray()
        d = np.diag(A)
        lam = np.max(np.abs(np.linalg.eigvals(A / d[:, None])))
        bound = const_lam_max(S.w33)
        assert lam <= bound + 1e-12, (S.side, lam, bound)


def test_chebyshev_on_variable_coefficient_levels():
    """Chebyshev must work where the analytic bound can't —
    genuinely variable-coefficient levels (w33 is None), via the
    setup-time power-iteration lambda_max estimate stored per level."""
    import jax.numpy as jnp
    import numpy as np
    import scipy.sparse as sp
    from amg_jax.models import poisson
    from amg_jax.structured import build_stencil_hierarchy, solve_stencil

    side = 31
    A = poisson.laplacian_scipy(side).tocsr()
    # smoothly varying diagonal perturbation: keeps symmetry/definiteness
    # (negative-definite convention) but breaks stencil constancy
    x = np.linspace(0.0, 1.0, side)
    var = 0.3 * np.abs(A.diagonal()).mean() * np.outer(
        0.5 + 0.5 * np.sin(3 * x), 0.5 + 0.5 * np.cos(2 * x)).reshape(-1)
    Avar = (A - sp.diags(var)).tocsr()

    hier = build_stencil_hierarchy(side, A_fine=Avar, dtype=jnp.float64,
                                   smoother="chebyshev")
    assert hier.levels[0].w33 is None, "fixture must be truly variable"
    assert hier.lam_maxes is not None and len(hier.lam_maxes) == len(
        hier.levels)
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    res = solve_stencil(hier, b2, tolerance=1e-9,
                        compute_error_every_n_iters=1)
    assert res.converged, (res.iterations, res.error)
    # oracle: direct solve of the same variable operator
    u_direct = np.linalg.solve(Avar.toarray(),
                               np.asarray(b2, dtype=np.float64).reshape(-1))
    np.testing.assert_allclose(np.asarray(res.u).reshape(-1), u_direct,
                               rtol=0, atol=1e-7)


def test_poisson_planes_pair_with_const_w33():
    """bench.py asserts poisson_const_w33 as the w33 of the
    device-built poisson_planes without re-detecting; guard the pairing so
    drift between the two builders can't silently corrupt the fast path."""
    import numpy as np
    import jax.numpy as jnp
    from amg_jax.ops.rap import poisson_const_w33, poisson_planes
    from amg_jax.sparse.stencil import detect_const_stencil

    for side in (7, 31):
        detected = detect_const_stencil(
            np.asarray(poisson_planes(side, jnp.float64)), side)
        assert detected is not None
        declared = poisson_const_w33(side, 1)[0]
        np.testing.assert_array_equal(np.asarray(detected),
                                      np.asarray(declared))
