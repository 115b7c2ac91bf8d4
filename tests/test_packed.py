"""Color-packed four-color GS (sparse/packed.py): every packed op must
agree with its full-field counterpart, and the packed V-cycle must match
vcycle_stencil — same algorithm, 1/4 the stencil evaluations."""

import numpy as np
import jax.numpy as jnp
import pytest

from amg_jax.models import poisson
from amg_jax.sparse.packed import (gs4_sweep_packed, pack,
                                   prolong_add_packed, residual_packed,
                                   restrict_packed, unpack)
from amg_jax.sparse.stencil import (Stencil2D, color_masks, gs4_sweep_masked)
from amg_jax.structured import (build_stencil_hierarchy, prolong_mm,
                                restrict_mm, vcycle_packed, vcycle_stencil)


def _fixture(side):
    S = Stencil2D.from_scipy(poisson.laplacian_scipy(side), side,
                             dtype=jnp.float64)
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.standard_normal((side, side)))
    b = jnp.asarray(rng.standard_normal((side, side)))
    return S, u, b


def test_pack_unpack_roundtrip():
    side = 11
    _, u, _ = _fixture(side)
    m = (side - 1) // 2
    np.testing.assert_array_equal(np.asarray(unpack(pack(u, m), m)),
                                  np.asarray(u))
    # pad cells of a packed field are exactly zero
    u4 = np.asarray(pack(u, m))
    assert (u4[1][:, m] == 0).all() and (u4[2][m, :] == 0).all()
    assert (u4[3][m, :] == 0).all() and (u4[3][:, m] == 0).all()


@pytest.mark.parametrize("side", [9, 31])
@pytest.mark.parametrize("symmetric", [True, False])
def test_packed_sweep_matches_masked(side, symmetric):
    S, u, b = _fixture(side)
    m = (side - 1) // 2
    want = gs4_sweep_masked(S, u, b, color_masks(side, jnp.float64),
                            0.9, symmetric)
    got = unpack(gs4_sweep_packed(pack(u, m), pack(b, m), S.w33, m,
                                  0.9, symmetric), m)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12, atol=1e-13)


def test_packed_residual_matches_full():
    side = 31
    S, u, b = _fixture(side)
    m = (side - 1) // 2
    want = b - S.matvec2(u)
    got = unpack(residual_packed(pack(u, m), pack(b, m), S.w33, m), m)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12, atol=1e-12)


def test_packed_transfer_matches_mm():
    side = 31
    m = (side - 1) // 2
    hier = build_stencil_hierarchy(side, dtype=jnp.float64)
    rng = np.random.default_rng(5)
    r = jnp.asarray(rng.standard_normal((side, side)))
    want_c = restrict_mm(r, hier.P1s[0])
    got_c = restrict_packed(pack(r, m), m)
    np.testing.assert_allclose(np.asarray(got_c), np.asarray(want_c),
                               rtol=1e-12, atol=1e-13)

    uc = jnp.asarray(rng.standard_normal((m, m)))
    want_f = prolong_mm(uc, hier.P1s[0])
    got_f = unpack(prolong_add_packed(pack(jnp.zeros((side, side)), m),
                                      uc, m), m)
    np.testing.assert_allclose(np.asarray(got_f), np.asarray(want_f),
                               rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("side", [31, 63])
def test_packed_vcycle_matches_stencil_vcycle(side):
    hier = build_stencil_hierarchy(side, dtype=jnp.float64)
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    u = jnp.zeros_like(b2)
    v = jnp.zeros_like(b2)
    for _ in range(3):
        u = vcycle_stencil(hier, u, b2)
        v = vcycle_packed(hier, v, b2, min_side=0)
    np.testing.assert_allclose(np.asarray(v), np.asarray(u),
                               rtol=1e-11, atol=1e-13)


def test_packed_solver_converges_to_direct():
    side = 31
    from amg_jax.structured import StructuredSolver

    s = StructuredSolver(side, smoother="packed", device_setup=False,
                         packed_min_side=0)
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    res = s.solve_ir_fused(b2, tolerance=1e-9)
    assert res.converged, (res.iterations, res.error)
    A = poisson.laplacian_scipy(side)
    u_direct = np.linalg.solve(A.toarray(), np.asarray(b2).reshape(-1))
    np.testing.assert_allclose(np.asarray(res.u).reshape(-1), u_direct,
                               rtol=0, atol=1e-7)


def test_pack_rect_roundtrip_and_window_steps():
    """Rectangular slab packing + windowed packed steps (the distributed
    smoother's building blocks) agree with the full-width masked window
    steps of the structured distributed path."""
    from amg_jax.parallel.structured_dist import _masked_steps_const
    from amg_jax.sparse.packed import (pack_rect, packed_steps_window,
                                       unpack_rect)

    side = 21
    m = (side - 1) // 2
    R = 30  # even window rows (tall enough to leave a compared band)
    rng = np.random.default_rng(7)
    u = jnp.asarray(rng.standard_normal((R, side)))
    b = jnp.asarray(rng.standard_normal((R, side)))
    np.testing.assert_array_equal(
        np.asarray(unpack_rect(pack_rect(u, m), m)), np.asarray(u))

    S = Stencil2D.from_scipy(poisson.laplacian_scipy(side), side,
                             dtype=jnp.float64)
    row0 = -2  # window starts two ghost rows above the grid (even)
    want = _masked_steps_const(S.w33, u, b, jnp.int32(row0), side, 1,
                               0.9, True)
    got = unpack_rect(packed_steps_window(
        S.w33, pack_rect(u, m), pack_rect(b, m), jnp.int32(row0), side,
        1, 0.9, True), m)
    # compare rows whose updates had fully valid inputs (ghost-zone
    # induction discards the window-edge rows)
    W = 8 + 1
    assert R - W + 1 > W  # non-empty compared band
    np.testing.assert_allclose(np.asarray(got)[W:R - W + 1],
                               np.asarray(want)[W:R - W + 1],
                               rtol=1e-12, atol=1e-13)


def _variable_operator(side):
    import scipy.sparse as sp

    A = poisson.laplacian_scipy(side).tocsr()
    x = np.linspace(0.0, 1.0, side)
    var = 0.25 * np.abs(A.diagonal()).mean() * np.outer(
        0.5 + 0.5 * np.sin(2 * x), 0.5 + 0.5 * np.cos(3 * x)).reshape(-1)
    return (A - sp.diags(var)).tocsr()


def test_packed_var_sweep_matches_masked():
    """Variable-coefficient packed sweep (packed planes) == masked sweep
    on a genuinely variable operator."""
    from amg_jax.sparse.packed import gs4_sweep_packed_var, pack_planes

    side = 31
    m = (side - 1) // 2
    S = Stencil2D.from_scipy(_variable_operator(side), side,
                             dtype=jnp.float64)
    assert S.w33 is None
    rng = np.random.default_rng(11)
    u = jnp.asarray(rng.standard_normal((side, side)))
    b = jnp.asarray(rng.standard_normal((side, side)))
    want = gs4_sweep_masked(S, u, b, color_masks(side, jnp.float64),
                            0.9, True)
    cp = pack_planes(S.c, m)
    got = unpack(gs4_sweep_packed_var(cp, pack(u, m), pack(b, m), m,
                                      0.9, True), m)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12, atol=1e-13)


def test_packed_vcycle_variable_matches_and_solves():
    """vcycle_packed on a variable-coefficient hierarchy matches
    vcycle_stencil, and the packed solver converges to the direct
    solution."""
    from amg_jax.structured import StructuredSolver

    side = 31
    Avar = _variable_operator(side)
    hier = build_stencil_hierarchy(side, A_fine=Avar, dtype=jnp.float64)
    assert hier.levels[0].w33 is None
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    u = jnp.zeros_like(b2)
    v = jnp.zeros_like(b2)
    for _ in range(3):
        u = vcycle_stencil(hier, u, b2)
        v = vcycle_packed(hier, v, b2, min_side=0)
    np.testing.assert_allclose(np.asarray(v), np.asarray(u),
                               rtol=1e-11, atol=1e-13)

    s = StructuredSolver(side, smoother="packed", A_fine=Avar,
                         packed_min_side=0)
    res = s.solve_ir_fused(b2, tolerance=1e-9)
    assert res.converged, (res.iterations, res.error)
    u_direct = np.linalg.solve(Avar.toarray(),
                               np.asarray(b2, dtype=np.float64).reshape(-1))
    np.testing.assert_allclose(np.asarray(res.u).reshape(-1), u_direct,
                               rtol=0, atol=1e-7)
