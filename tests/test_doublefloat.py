"""Double-float32 arithmetic (ops/doublefloat.py): error-free transforms,
residual accuracy vs f64, and the df32 solve path."""

import jax
import jax.numpy as jnp
import numpy as np

from amg_jax.models import poisson
from amg_jax.ops.doublefloat import (DF32, df_add, df_add_f32, df_mul,
                                     df_residual, df_rss, two_prod, two_sum)
from amg_jax.structured import StructuredSolver, build_fine_stencil_f64


def test_two_sum_exact():
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal(1000), dtype=jnp.float32)
    b = jnp.asarray(rng.standard_normal(1000) * 1e-4, dtype=jnp.float32)
    s, e = jax.jit(two_sum)(a, b)
    exact = a.astype(jnp.float64) + b.astype(jnp.float64)
    got = s.astype(jnp.float64) + e.astype(jnp.float64)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(exact))


def test_two_prod_exact():
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.standard_normal(1000), dtype=jnp.float32)
    b = jnp.asarray(rng.standard_normal(1000), dtype=jnp.float32)
    p, e = jax.jit(two_prod)(a, b)
    exact = a.astype(jnp.float64) * b.astype(jnp.float64)
    got = p.astype(jnp.float64) + e.astype(jnp.float64)
    # f32 x f32 products are exactly representable in f64
    np.testing.assert_array_equal(np.asarray(got), np.asarray(exact))


def test_df32_roundtrip_and_ops():
    rng = np.random.default_rng(2)
    x64 = jnp.asarray(rng.standard_normal(500))
    y64 = jnp.asarray(rng.standard_normal(500))
    x, y = DF32.from_f64(x64), DF32.from_f64(y64)
    np.testing.assert_allclose(np.asarray(x.to_f64()), np.asarray(x64),
                               rtol=0, atol=1e-14)
    # Additions must be bounded ABSOLUTELY: when x + y cancels, the df32
    # input representation error (~2^-49 |x|) dominates and no relative
    # bound holds for any implementation. df_add's own error is ~2^-46 of
    # the operand magnitude; combined with the input rounding, bound the
    # error elementwise by 2^-45 * max(|x|, |y|).
    add_tol = 2.0 ** -45 * np.maximum(np.abs(np.asarray(x64)),
                                      np.abs(np.asarray(y64)))
    s = jax.jit(df_add)(x, y)
    err = np.abs(np.asarray(s.to_f64()) - np.asarray(x64 + y64))
    assert np.all(err <= add_tol), float((err / add_tol).max())
    # Products preserve relative error (no cancellation), so a relative
    # bound is valid: ~2^-46 from df_mul plus ~2^-48 input rounding.
    p = jax.jit(df_mul)(x, y)
    np.testing.assert_allclose(np.asarray(p.to_f64()),
                               np.asarray(x64 * y64), rtol=3e-14, atol=0)
    z = jax.jit(df_add_f32)(x, y.hi)
    err = np.abs(np.asarray(z.to_f64())
                 - np.asarray(x64 + y.hi.astype(jnp.float64)))
    assert np.all(err <= add_tol), float((err / add_tol).max())


def test_df_residual_matches_f64():
    """df32 residual agrees with the f64 residual to ~2^-48 of the operator
    scale — far below the reference tolerances."""
    side = 63
    A64 = build_fine_stencil_f64(side)
    b64 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    rng = np.random.default_rng(3)
    u64 = jnp.asarray(rng.standard_normal((side, side)) * 0.1)
    r64 = b64 - A64.matvec2(u64)
    r_df = jax.jit(df_residual)(DF32.from_f64(A64.c), DF32.from_f64(b64),
                                DF32.from_f64(u64))
    scale = float(jnp.abs(A64.c).max() * jnp.abs(u64).max())
    err = np.abs(np.asarray(r_df.to_f64() - r64)).max()
    assert err < 1e-12 * scale
    np.testing.assert_allclose(float(df_rss(r_df)),
                               float(jnp.sum(r64 * r64)), rtol=1e-10)


def test_df32_solver_matches_f64_solver():
    side = 31
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    r_df = StructuredSolver(side, precision="df32").solve_ir_fused(
        b2, tolerance=1e-10)
    r_64 = StructuredSolver(side, precision="f64").solve_ir_fused(
        b2, tolerance=1e-10)
    assert r_df.converged and r_64.converged
    np.testing.assert_allclose(np.asarray(r_df.u), np.asarray(r_64.u),
                               rtol=0, atol=1e-11)
