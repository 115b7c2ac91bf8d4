"""Double-float32 (df32) arithmetic — f64-grade residuals from f32 flops.

The mixed-precision solve (structured.StructuredSolver) needs an f64-grade
defect-correction residual. A df32 number is an unevaluated pair
``hi + lo`` of f32 with ``|lo| <= ulp(hi)/2``, giving a ~48-bit
significand (relative eps ~ 3.6e-15) — enough for the reference's
1e-9-scale rss tolerances (common.hpp:17-27) — while every operation is a
handful of native f32 flops and the fields stay f32 in memory. (Whether
native f64 is as fast on the GPU is an open measurement.)

Classic error-free transformations (Dekker 1971, Knuth TwoSum); no fma is
assumed (XLA exposes none portably), so TwoProd uses Veltkamp splitting.
XLA does not re-associate floating point by default, so the cancellation
tricks below survive compilation; do NOT enable fast-math-like flags
around this module. If the compiler contracts a multiply and an add into
an fma, the transforms stay exact: every product they form of split
halves is exact, and ``c - (c - a)`` with ``c = 4097 a`` still leaves a
12-bit ``hi`` (chip_smoke.py checks all three against f64 on the GPU).

Used by ``df_residual`` to compute ``r = b - A u`` on a Stencil2D level
(sparse/stencil.py) in df32: the replacement for the reference's f64 Eigen
residual (multigrid.hpp:272-274) inside iterative refinement.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

_SPLIT = 4097.0  # 2^12 + 1: Veltkamp split factor for the 24-bit f32 mantissa


def two_sum(a, b):
    """s + e = a + b exactly (Knuth), no magnitude ordering assumed."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """s + e = a + b exactly, assuming |a| >= |b| (Dekker fast path)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split_f32(a):
    """Veltkamp split: a = hi + lo with 12-bit halves (exact f32 products)."""
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def split_f64(x64):
    """x64 = hi + lo (to 2^-48 relative) with f32 ``hi`` and ``lo``.

    The optimization barrier keeps the f32 rounding of ``hi`` visible to
    the subtraction: under XLA's default excess-precision rule the GPU
    compiler folds ``convert(convert(x, f32), f64)`` back to ``x``, which
    makes ``lo`` zero and silently truncates the operand to f32 (on the
    H100 that left the true rss of a 1023^2 solve 100x above the rss the
    solver measured)."""
    hi = x64.astype(jnp.float32)
    hi64 = jax.lax.optimization_barrier(hi).astype(x64.dtype)
    return hi, (x64 - hi64).astype(jnp.float32)


def two_prod(a, b):
    """p + e = a * b exactly (Dekker TwoProd via Veltkamp splitting)."""
    p = a * b
    ah, al = split_f32(a)
    bh, bl = split_f32(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


@partial(jax.tree_util.register_dataclass, data_fields=["hi", "lo"],
         meta_fields=[])
@dataclasses.dataclass(frozen=True)
class DF32:
    """A double-float32 array: value = hi + lo elementwise."""

    hi: jnp.ndarray
    lo: jnp.ndarray

    @staticmethod
    def from_f64(x64) -> "DF32":
        if x64.dtype != jnp.float64:
            # Without jax_enable_x64 the "f64" input is silently f32 and lo
            # collapses to zero — the solver would run plain f32 masquerading
            # as df32 and stall above tolerance with no error raised.
            raise ValueError(
                f"DF32.from_f64 requires a float64 input, got {x64.dtype}; "
                "enable jax_enable_x64 (or use DF32.from_f32 deliberately)")
        hi, lo = split_f64(x64)
        return DF32(hi=hi, lo=lo)

    @staticmethod
    def from_f32(x32) -> "DF32":
        return DF32(hi=x32, lo=jnp.zeros_like(x32))

    def to_f64(self):
        return self.hi.astype(jnp.float64) + self.lo.astype(jnp.float64)

    @property
    def shape(self):
        return self.hi.shape


def df_add(a: DF32, b: DF32) -> DF32:
    """a + b with full double-float renormalization."""
    s, e = two_sum(a.hi, b.hi)
    e = e + a.lo + b.lo
    hi, lo = quick_two_sum(s, e)
    return DF32(hi=hi, lo=lo)


def df_add_f32(a: DF32, x) -> DF32:
    """a + x for plain-f32 x (e.g. a V-cycle correction)."""
    s, e = two_sum(a.hi, x)
    hi, lo = quick_two_sum(s, e + a.lo)
    return DF32(hi=hi, lo=lo)


def df_neg(a: DF32) -> DF32:
    return DF32(hi=-a.hi, lo=-a.lo)


def df_mul(a: DF32, b: DF32) -> DF32:
    """a * b (dropping the negligible lo*lo term)."""
    p, e = two_prod(a.hi, b.hi)
    e = e + a.hi * b.lo + a.lo * b.hi
    hi, lo = quick_two_sum(p, e)
    return DF32(hi=hi, lo=lo)


def df_residual(c_df: DF32, b_df: DF32, u_df: DF32) -> DF32:
    """r = b - A u on an n x n field in df32, for a 9-point stencil level
    with df32 coefficient planes ``c_df`` (shape (3,3,n,n) each).

    Same shifted-slice structure as Stencil2D.matvec2 (sparse/stencil.py)
    but every multiply is a TwoProd and every accumulate a TwoSum — ~10x
    the f32 flops of a plain matvec. Accuracy: componentwise
    ~2^-48 relative to the largest intermediate term, i.e. rss noise floor
    ~1e-12 for the 1M-dof Poisson case (vs 1e-7 tolerances).
    """
    n = u_df.hi.shape[0]
    pad = lambda x: jnp.pad(x, 1)
    uh, ul = pad(u_df.hi), pad(u_df.lo)
    acc = DF32.from_f32(jnp.zeros_like(u_df.hi))
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            ch = c_df.hi[dj + 1, di + 1]
            cl = c_df.lo[dj + 1, di + 1]
            sl = lambda z: jax.lax.slice(z, (1 + dj, 1 + di),
                                         (1 + dj + n, 1 + di + n))
            term = df_mul(DF32(hi=ch, lo=cl), DF32(hi=sl(uh), lo=sl(ul)))
            acc = df_add(acc, term)
    return df_add(b_df, df_neg(acc))


def df_residual_const(w33, b_df: DF32, u_df: DF32) -> DF32:
    """r = b - A u in df32 for a CONSTANT 3x3 stencil (Stencil2D.w33).

    Each weight enters as an exact (hi, lo) float pair — compile-time
    constants — so the residual reads only u and b from HBM: 18 fewer
    field reads per refinement step than the plane-based df_residual.
    Zero padding supplies the boundary truncation exactly as in
    Stencil2D.matvec2. Pow2 weights (Poisson on 2^k-1 grids) take the
    exact-product TwoSum-cascade fast path (~3x fewer flops).
    """
    import numpy as np

    n = u_df.hi.shape[0]
    pad = lambda x: jnp.pad(x, 1)
    uh, ul = pad(u_df.hi), pad(u_df.lo)

    def sl_of(dj, di):
        return lambda z: jax.lax.slice(z, (1 + dj, 1 + di),
                                       (1 + dj + n, 1 + di + n))

    if is_pow2_weights(w33):
        s = b_df.hi
        c = b_df.lo
        for dj in (-1, 0, 1):
            for di in (-1, 0, 1):
                w = w33[dj + 1][di + 1]
                if w == 0.0:
                    continue
                sl = sl_of(dj, di)
                wf = jnp.float32(-w)
                t = wf * sl(uh)        # exact: w is +/-2^j
                s, e = two_sum(s, t)
                c = c + e + wf * sl(ul)
        hi, lo = two_sum(s, c)
        return DF32(hi=hi, lo=lo)

    acc = DF32.from_f32(jnp.zeros_like(u_df.hi))
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            w = w33[dj + 1][di + 1]
            if w == 0.0:
                continue
            w_hi = float(np.float32(w))
            w_lo = float(np.float32(w - w_hi))
            sl = sl_of(dj, di)
            term = df_mul(DF32(hi=jnp.float32(w_hi), lo=jnp.float32(w_lo)),
                          DF32(hi=sl(uh), lo=sl(ul)))
            acc = df_add(acc, term)
    return df_add(b_df, df_neg(acc))


def df_rss(r_df: DF32, dtype=None):
    """Residual sum of squares of a df32 residual, accumulated in f64.

    The elementwise squares run as df32 TwoProds (plain f32 work); only
    the two final reductions run in f64 adds. Falls back to f32 accumulation when x64 is disabled
    (e.g. the multichip dryrun environment).
    """
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    sq = df_mul(r_df, r_df)
    return jnp.sum(sq.hi.astype(dtype)) + jnp.sum(sq.lo.astype(dtype))


def df_rss_fast(r_df: DF32, dtype=None):
    """rss of a df32 residual with the f64 reduction minimized.

    df_rss squares every element as a TwoProd and reduces in f64. Here
    the squares stay plain f32 (hi^2 + 2 hi*lo — the lo^2 term is below
    2^-48 relative and drops), the inner axis reduces in f32 (pairwise
    tree, relative error ~log2(n)*eps_f32 ~ 1e-6 — far inside the ~1e-2
    accuracy a tolerance comparison needs), and only the tiny per-row
    vector converts to f64. Use inside solve loops; keep df_rss for
    reported/parity numbers where every digit matters.

    Magnitude floor: the squares are PLAIN f32, so a
    residual entry with |hi| below ~1e-19 underflows to a zero square —
    a solve on a rhs scaled so the converged residual sits below that
    floor would report rss = 0 and stop early where df_rss (df32
    squares) would not. Poisson-class systems with O(1) forcing sit ~15
    orders of magnitude above the floor; for tiny-scaled systems use
    df_rss or rescale the rhs.
    """
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    sq = r_df.hi * r_df.hi + 2.0 * (r_df.hi * r_df.lo)
    rows = jnp.sum(sq, axis=-1)
    return jnp.sum(rows.astype(dtype))


def is_pow2_weights(w33) -> bool:
    """True iff every nonzero stencil weight is +/- a power of two (then
    w * x is EXACT in f32 and df products need no TwoProd). Holds for the
    2-D Poisson fine operator on 2^k - 1 grids: h = 2^(1-k), so the
    weights +/-1/h^2 and -4/h^2 are exact powers of two."""
    import math

    for row in w33:
        for w in row:
            if w == 0.0:
                continue
            m_, _ = math.frexp(abs(float(w)))
            if m_ != 0.5:
                return False
    return True
