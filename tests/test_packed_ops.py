"""The XLA color-packed ops (sparse/packed.py) against independent
references, across sizes and sweep variants: every production level of
the structured solver runs these ops, on any backend."""

import numpy as np
import jax.numpy as jnp
import pytest
from hypothesis import given, settings, strategies as st

from amg_jax.models.varcoef import jump_planes
from amg_jax.ops.doublefloat import (DF32, split_f32, split_f64, two_prod,
                                     two_sum)
from amg_jax.ops.rap import interp1d_dense, poisson_const_w33
from amg_jax.sparse.packed import (df_residual_const_packed,
                                   gs4_sweep_packed, gs4_sweep_packed_var,
                                   pack, pack_planes, prolong_add_packed,
                                   residual_packed, restrict_packed, unpack)
from amg_jax.sparse.stencil import (Stencil2D, color_masks,
                                    gs4_sweep_masked)
from amg_jax.structured import prolong_mm, restrict_mm

SIDES = [31, 63, 127, 255]


def _fields(side, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((side, side)),
            rng.standard_normal((side, side)))


def _w33(side, level):
    """Poisson stencil on ``level`` of the Galerkin hierarchy of a grid of
    ``side`` (level 0: the 5-point operator; level 1: a full 9-point
    stencil)."""
    return poisson_const_w33(side, level + 1)[level]


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("omega", [1.0, 0.8])
def test_sweep_packed_matches_masked(side, symmetric, omega):
    m = (side - 1) // 2
    w33 = _w33(2 * side + 1, 1)  # a 9-point stencil
    S = Stencil2D.const(w33, side, dtype=jnp.float64)
    u, b = (jnp.asarray(x) for x in _fields(side))
    want = gs4_sweep_masked(S, u, b, color_masks(side, jnp.float64), omega,
                            symmetric)
    got = unpack(gs4_sweep_packed(pack(u, m), pack(b, m), w33, m, omega,
                                  symmetric), m)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("level", [0, 1])
def test_residual_packed_matches_scipy(side, level):
    """b - A u against scipy's f64 CSR product on the same operator."""
    m = (side - 1) // 2
    w33 = _w33(side if level == 0 else 2 * side + 1, level)
    u, b = _fields(side, seed=1)
    want = b.reshape(-1) - _csr_from_w33(w33, side) @ u.reshape(-1)
    got = unpack(residual_packed(pack(jnp.asarray(u), m),
                                 pack(jnp.asarray(b), m), w33, m), m)
    np.testing.assert_allclose(np.asarray(got).reshape(-1), want,
                               rtol=1e-12, atol=1e-9 * np.abs(want).max())


def _csr_from_w33(w33, n):
    """scipy CSR 9-point operator, dof = j*n + i, zero Dirichlet
    boundary."""
    import scipy.sparse as sp

    J, I = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    rows, cols, vals = [], [], []
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            jj, ii = J + dj, I + di
            ok = (jj >= 0) & (jj < n) & (ii >= 0) & (ii < n)
            rows.append((J * n + I)[ok])
            cols.append((jj * n + ii)[ok])
            vals.append(np.full(ok.sum(), w33[dj + 1][di + 1]))
    return sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                 np.concatenate(cols))),
                         shape=(n * n, n * n))


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("op", ["restrict", "prolong"])
def test_transfer_packed_matches_mm(side, op):
    m = (side - 1) // 2
    P1 = interp1d_dense(side, m, jnp.float64)
    u, _ = _fields(side, seed=2)
    if op == "restrict":
        want = restrict_mm(jnp.asarray(u), P1)
        got = restrict_packed(pack(jnp.asarray(u), m), m)
    else:
        uc = jnp.asarray(u[:m, :m])
        base = jnp.asarray(u)
        want = base + prolong_mm(uc, P1)
        got = unpack(prolong_add_packed(pack(base, m), uc, m), m)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12, atol=1e-12)


def _split(x64):
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo, hi.astype(np.float64) + lo.astype(np.float64)


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("pow2", [True, False])
def test_df_residual_const_packed_matches_f64(side, pow2):
    """df32 residual (pow2 TwoSum-cascade path, and the general TwoProd
    path for a non-power-of-two stencil) against an f64 residual of the
    same df32-representable fields."""
    m = (side - 1) // 2
    w33 = _w33(side, 0)
    if not pow2:
        w33 = tuple(tuple(3.0 * w for w in row) for row in w33)
    u, b = _fields(side, seed=3)
    uh, ul, u_ref = _split(u)
    bh, bl, b_ref = _split(b)
    want = b_ref.reshape(-1) - _csr_from_w33(w33, side) @ u_ref.reshape(-1)
    r = df_residual_const_packed(
        w33, DF32(hi=pack(jnp.asarray(bh), m), lo=pack(jnp.asarray(bl), m)),
        DF32(hi=pack(jnp.asarray(uh), m), lo=pack(jnp.asarray(ul), m)), m)
    got = (np.asarray(unpack(r.hi, m)).astype(np.float64)
           + np.asarray(unpack(r.lo, m)))
    want = np.asarray(want).reshape(side, side)
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("omega", [1.0, 0.8])
def test_sweep_packed_var_matches_masked(side, symmetric, omega):
    m = (side - 1) // 2
    c = jump_planes(side, a_in=100.0, dtype=jnp.float64)
    S = Stencil2D.from_planes(c, side)
    u, b = (jnp.asarray(x) for x in _fields(side, seed=4))
    want = gs4_sweep_masked(S, u, b, color_masks(side, jnp.float64), omega,
                            symmetric)
    got = unpack(gs4_sweep_packed_var(pack_planes(c, m), pack(u, m),
                                      pack(b, m), m, omega, symmetric), m)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12, atol=1e-12)


# df32 error-free transforms: exact against f64 on f32 inputs whose sums
# and products f64 holds exactly (exponents within [-20, 20])
_f32 = st.builds(lambda mant, e, s: np.float32(s * (1.0 + mant) * 2.0 ** e),
                 st.floats(0.0, 1.0, exclude_max=True),
                 st.integers(-20, 20), st.sampled_from([-1.0, 1.0]))


@settings(max_examples=200, deadline=None)
@given(_f32, _f32)
def test_two_sum_exact(a, b):
    s, e = (np.asarray(v) for v in two_sum(jnp.float32(a), jnp.float32(b)))
    assert s == np.float32(a) + np.float32(b)
    assert float(s) + float(e) == float(a) + float(b)


@settings(max_examples=200, deadline=None)
@given(_f32)
def test_split_f32_exact(a):
    hi, lo = (np.asarray(v) for v in split_f32(jnp.float32(a)))
    assert float(hi) + float(lo) == float(a)
    for half in (hi, lo):
        mant, _ = np.frexp(float(half))
        assert mant * 2 ** 12 == int(mant * 2 ** 12)  # <= 12 bits


@settings(max_examples=200, deadline=None)
@given(_f32, _f32)
def test_two_prod_exact(a, b):
    p, e = (np.asarray(v) for v in two_prod(jnp.float32(a), jnp.float32(b)))
    assert p == np.float32(a) * np.float32(b)
    assert float(e) == float(a) * float(b) - float(p)


@settings(max_examples=200, deadline=None)
@given(st.builds(lambda mant, e, s: s * (1.0 + mant) * 2.0 ** e,
                 st.floats(0.0, 1.0, exclude_max=True), st.integers(-60, 60),
                 st.sampled_from([-1.0, 1.0])))
def test_split_f64_exact(x):
    """hi = f32(x) and lo = f32(x - hi), inside one jitted program (where a
    compiler may fold the f64 -> f32 -> f64 round trip); magnitudes where
    both halves are normal f32 numbers."""
    import jax

    hi, lo = (np.asarray(v) for v in jax.jit(split_f64)(jnp.float64(x)))
    assert hi == np.float32(x)
    assert lo == np.float32(x - float(np.float32(x)))
