"""Color-packed four-color Gauss-Seidel — the speed-of-light smoother path.

The masked sweep (sparse/stencil.py gs4_sweep_masked) computes a FULL-WIDTH
9-point update at every color step and throws 3/4 of it away with the color
mask: 8 x n^2 stencil evaluations per symmetric sweep. This module stores
the field *packed by color* — four contiguous quarter-grids, one per
(row parity, col parity) class — so each color step evaluates the stencil
only at the n^2/4 points it actually updates, reading neighbors from the
other three quarters with unit-stride shifts. 4x less arithmetic and no
strided access anywhere (the classic red-black packing, extended to the
four-color 9-point case; every op is a contiguous (M, M) slice/add that
XLA fuses).

Layout: n = 2m+1 (odd interior sides), M = m+1. Quarter q[pj][pi] holds
real points (2J+pj, 2I+pi); all four are padded to (M, M) — q00 is full,
q01 has one zero pad column, q10 one pad row, q11 both. Pad cells stay
exactly zero (updates are masked), which doubles as the Dirichlet zero
boundary: stencil reads past the real grid land on pad zeros.

Neighbor algebra: for target color (pj, pi) and offset (dj, di), the
source color is b = ((pj+dj) mod 2, (pi+di) mod 2) and the source index
shift is s = ((pj+dj-bj)//2, (pi+di-bi)//2) in {-1,0,1}^2 — a unit-stride
shifted read of one quarter.

The full fine-level pipeline works packed (sweep, residual, restriction,
prolongation-correction), so a V-cycle level pays pack/unpack only at its
entry/exit (amg_jax/structured.py vcycle_packed). Replaces the reference's
sequential sweep (smoother.hpp:86-216, the #1 hot loop).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

# color order must match sparse/stencil.py _COLORS (and its reverse for
# the symmetric sweep) so iterates agree with the masked path exactly
COLORS = ((0, 0), (0, 1), (1, 0), (1, 1))


def pack(u2: jnp.ndarray, m: int) -> jnp.ndarray:
    """(n, n) field with n = 2m+1 -> (4, M, M) color-packed, M = m+1.

    Two SINGLE-AXIS shuffles with an optimization barrier between, not
    one combined quarter transpose: XLA lowers each one-axis
    (de)interleave near memory speed but lowered the fused two-axis form
    far slower on the accelerator it was written for (the barrier stops
    it re-fusing; its cost on the GPU is not measured). No strided slicing
    and no scatter anywhere (a strided .at[::2].set lowers to scatter)."""
    if u2.shape[-1] != 2 * m + 1:
        raise ValueError(f"pack expects an odd ({2*m+1})-sided field, "
                         f"got {u2.shape}")
    M = m + 1
    u2p = jnp.pad(u2, ((0, 1), (0, 1)))  # (2M, 2M); pad row/col -> zeros
    v = u2p.reshape(2 * M, M, 2).transpose(2, 0, 1)   # cols: (pi, 2M, M)
    v = lax.optimization_barrier(v)
    w = v.reshape(2, M, 2, M).transpose(0, 2, 1, 3)   # rows: (pi, pj, ...)
    return w.transpose(1, 0, 2, 3).reshape(4, M, M)   # (pj, pi) order


def unpack(u4: jnp.ndarray, m: int) -> jnp.ndarray:
    """(4, M, M) color-packed -> (n, n), n = 2m+1 (inverse of pack)."""
    M = m + 1
    n = 2 * m + 1
    w = u4.reshape(2, 2, M, M).transpose(1, 0, 2, 3)   # (pi, pj, M, M)
    v = w.transpose(0, 2, 1, 3).reshape(2, 2 * M, M)   # rows reinterleave
    v = lax.optimization_barrier(v)
    u2p = v.transpose(1, 2, 0).reshape(2 * M, 2 * M)   # cols reinterleave
    return u2p[:n, :n]


def _shift(q: jnp.ndarray, sJ: int, sI: int) -> jnp.ndarray:
    """out[J, I] = q[J+sJ, I+sI], zero outside (sJ, sI in {-1,0,1})."""
    if sJ == 0 and sI == 0:
        return q
    M, N = q.shape
    qp = jnp.pad(q, 1)
    return lax.slice(qp, (1 + sJ, 1 + sI), (1 + sJ + M, 1 + sI + N))


def _valid(pj: int, pi: int, m: int, dtype):
    """(M, M) 0/1 mask of the real cells of quarter (pj, pi): iota-based,
    so it compiles to predicates, not a stored array."""
    M = m + 1
    J = lax.broadcasted_iota(jnp.int32, (M, M), 0)
    I = lax.broadcasted_iota(jnp.int32, (M, M), 1)
    Mj = M if pj == 0 else m
    Mi = M if pi == 0 else m
    return ((J < Mj) & (I < Mi)).astype(dtype)


def _neighbors(pj: int, pi: int):
    """Static (weight-index, source-quarter, shift) list for one color."""
    out = []
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            if dj == 0 and di == 0:
                continue
            bj = (pj + dj) % 2
            bi = (pi + di) % 2
            sJ = (pj + dj - bj) // 2
            sI = (pi + di - bi) // 2
            out.append(((dj + 1, di + 1), 2 * bj + bi, (sJ, sI)))
    return out


def _acc(u4, w33, pj: int, pi: int):
    """Off-diagonal stencil accumulation at the (pj, pi) points."""
    acc = jnp.zeros_like(u4[0])
    for (wj, wi), src, (sJ, sI) in _neighbors(pj, pi):
        w = w33[wj][wi]
        if w == 0.0:
            continue
        acc = acc + w * _shift(u4[src], sJ, sI)
    return acc


def gs4_sweep_packed(u4: jnp.ndarray, b4: jnp.ndarray, w33, m: int,
                     omega: float = 1.0, symmetric: bool = True
                     ) -> jnp.ndarray:
    """One (symmetric) four-color GS sweep on packed fields.

    Produces the same iterates as gs4_sweep_masked on the unpacked field
    (same color order; tests/test_packed.py) at 1/4 the stencil
    evaluations."""
    inv_diag = 1.0 / w33[1][1]
    order = list(COLORS)
    if symmetric:
        order = order + order[::-1]
    for pj, pi in order:
        a = 2 * pj + pi
        acc = _acc(u4, w33, pj, pi)
        delta = (b4[a] - acc) * inv_diag - u4[a]
        mask = _valid(pj, pi, m, u4.dtype)
        u4 = u4.at[a].set(u4[a] + (omega * mask) * delta)
    return u4


def residual_packed(u4: jnp.ndarray, b4: jnp.ndarray, w33, m: int
                    ) -> jnp.ndarray:
    """r = b - A u, color-packed (pad cells carry zero residual)."""
    w_c = w33[1][1]
    r4 = jnp.zeros_like(u4)
    for pj, pi in COLORS:
        a = 2 * pj + pi
        acc = _acc(u4, w33, pj, pi) + w_c * u4[a]
        mask = _valid(pj, pi, m, u4.dtype)
        r4 = r4.at[a].set(mask * (b4[a] - acc))
    return r4


def restrict_packed(r4: jnp.ndarray, m: int) -> jnp.ndarray:
    """Full-weighting restriction from the packed fine residual straight
    to the DENSE coarse field (coarse side = m; coarse point (J, I) sits
    at fine (2J+1, 2I+1) — the (1,1) quarter — so every read below is a
    contiguous quarter-grid slice; equals restrict_mm / restrict_fw)."""
    r00, r01, r10, r11 = r4[0], r4[1], r4[2], r4[3]
    c = r11[:m, :m]
    c = c + 0.5 * (r01[:m, :m] + r01[1:m + 1, :m]
                   + r10[:m, :m] + r10[:m, 1:m + 1])
    c = c + 0.25 * (r00[:m, :m] + r00[:m, 1:m + 1]
                    + r00[1:m + 1, :m] + r00[1:m + 1, 1:m + 1])
    return c


def pack_planes(c: jnp.ndarray, m: int) -> jnp.ndarray:
    """(3, 3, n, n) coefficient planes -> (3, 3, 4, M, M) color-packed.

    cp[dj+1, di+1, a] holds the (dj, di) coefficient at the color-a
    TARGET points — exactly pack() of each plane. Inside a solve loop the
    planes are loop-invariant, so XLA hoists this out of the while_loop
    (one pack per solve dispatch, not per cycle)."""
    return jnp.stack([jnp.stack([pack(c[dj, di], m) for di in range(3)])
                      for dj in range(3)])


def gs4_sweep_packed_var(cp: jnp.ndarray, u4: jnp.ndarray,
                         b4: jnp.ndarray, m: int, omega: float = 1.0,
                         symmetric: bool = True) -> jnp.ndarray:
    """Variable-coefficient color-packed GS sweep: like gs4_sweep_packed
    but weights come from packed planes (pack_planes) instead of a static
    w33 — the packed analog of the plane-based masked sweep. Reads 8
    coefficient quarters + 3 neighbor quarters per color step; still
    evaluates the stencil only at the points it updates."""
    order = list(COLORS)
    if symmetric:
        order = order + order[::-1]
    for pj, pi in order:
        a = 2 * pj + pi
        acc = jnp.zeros_like(u4[a])
        for (wj, wi), src, (sJ, sI) in _neighbors(pj, pi):
            acc = acc + cp[wj, wi, a] * _shift(u4[src], sJ, sI)
        diag = cp[1, 1, a]
        inv_diag = jnp.where(diag != 0, 1.0 / jnp.where(diag != 0, diag,
                                                        1.0), 0.0)
        delta = (b4[a] - acc) * inv_diag - u4[a]
        mask = _valid(pj, pi, m, u4.dtype)
        u4 = u4.at[a].set(u4[a] + (omega * mask) * delta)
    return u4


def residual_packed_var(cp: jnp.ndarray, u4: jnp.ndarray, b4: jnp.ndarray,
                        m: int) -> jnp.ndarray:
    """r = b - A u, color-packed, variable coefficients (pad cells carry
    zero residual)."""
    r4 = jnp.zeros_like(u4)
    for pj, pi in COLORS:
        a = 2 * pj + pi
        acc = cp[1, 1, a] * u4[a]
        for (wj, wi), src, (sJ, sI) in _neighbors(pj, pi):
            acc = acc + cp[wj, wi, a] * _shift(u4[src], sJ, sI)
        mask = _valid(pj, pi, m, u4.dtype)
        r4 = r4.at[a].set(mask * (b4[a] - acc))
    return r4


def pack_rect(u2: jnp.ndarray, m: int) -> jnp.ndarray:
    """(R, n) slab with R even, n = 2m+1 -> (4, R/2, M) color-packed.

    The distributed form: row slabs keep their own (even) row count while
    columns span the full (odd) grid side. Same two-single-axis-shuffle
    construction as ``pack``."""
    R, n = u2.shape
    if R % 2 or n != 2 * m + 1:
        raise ValueError(f"pack_rect expects even rows and side {2*m+1}, "
                         f"got {u2.shape}")
    M = m + 1
    u2p = jnp.pad(u2, ((0, 0), (0, 1)))               # (R, 2M)
    v = u2p.reshape(R, M, 2).transpose(2, 0, 1)       # cols: (pi, R, M)
    v = lax.optimization_barrier(v)
    w = v.reshape(2, R // 2, 2, M).transpose(0, 2, 1, 3)
    return w.transpose(1, 0, 2, 3).reshape(4, R // 2, M)


def unpack_rect(u4: jnp.ndarray, m: int) -> jnp.ndarray:
    """(4, R/2, M) color-packed slab -> (R, n) (inverse of pack_rect)."""
    _, R2, M = u4.shape
    w = u4.reshape(2, 2, R2, M).transpose(1, 0, 2, 3)  # (pi, pj, R2, M)
    v = w.transpose(0, 2, 1, 3).reshape(2, 2 * R2, M)
    v = lax.optimization_barrier(v)
    u2p = v.transpose(1, 2, 0).reshape(2 * R2, 2 * M)
    return u2p[:, :2 * m + 1]


def packed_steps_window(w33, u4, b4, row0_g, side: int, sweeps: int,
                        omega: float, symmetric: bool):
    """Color-packed GS steps on an arbitrary row window (the packed analog
    of structured_dist._masked_steps_const): quarter cell (a=2pj+pi, J, I)
    is global point (row0_g + 2J + pj, 2I + pi); points outside
    [0, side)^2 are masked off (zero-padding boundary semantics), window
    edge rows are left invalid for the caller's ghost-zone margin to
    discard. ``row0_g`` must be even so local parity == global parity."""
    R2, M = u4.shape[1], u4.shape[2]
    inv_diag = 1.0 / w33[1][1]
    iJ = lax.broadcasted_iota(jnp.int32, (R2, M), 0)
    iI = lax.broadcasted_iota(jnp.int32, (R2, M), 1)
    order = list(COLORS)
    if symmetric:
        order = order + order[::-1]
    for _ in range(sweeps):
        for pj, pi in order:
            a = 2 * pj + pi
            row_g = row0_g + 2 * iJ + pj
            col_g = 2 * iI + pi
            valid = (row_g >= 0) & (row_g < side) & (col_g < side)
            acc = _acc(u4, w33, pj, pi)
            delta = (b4[a] - acc) * inv_diag - u4[a]
            u4 = u4.at[a].set(u4[a]
                              + jnp.where(valid, omega * delta, 0.0))
    return u4


def _df_residual_pow2_packed(w33, b4_df, u4_df, m: int):
    """Pow2-weight fast path for df_residual_const_packed: when every
    nonzero weight is +/-2^j, w * x is EXACT in f32, so each stencil term
    needs one multiply instead of a Veltkamp TwoProd, and the df_add
    chain collapses to a TwoSum CASCADE (sum the exact terms, carry the
    roundoff). The lo-component contribution (A u_lo, b_lo) runs in plain
    f32 — its own rounding is O(eps^2) relative to the residual. ~3x
    fewer flops than the general path; bit-accuracy class unchanged
    (~2^-48 relative)."""
    from amg_jax.ops.doublefloat import DF32, two_sum

    r_hi, r_lo = [], []
    for pj, pi in COLORS:
        a = 2 * pj + pi
        terms = [((1, 1), a, (0, 0))] + _neighbors(pj, pi)
        s = b4_df.hi[a]
        c = b4_df.lo[a]          # lo parts + accumulated roundoff
        for (wj, wi), src, (sJ, sI) in terms:
            w = w33[wj][wi]
            if w == 0.0:
                continue
            wf = jnp.float32(-w)
            t = wf * _shift(u4_df.hi[src], sJ, sI)   # exact (pow2 w)
            s, e = two_sum(s, t)
            c = c + e + wf * _shift(u4_df.lo[src], sJ, sI)
        hi, lo = two_sum(s, c)
        mask = _valid(pj, pi, m, u4_df.hi.dtype)
        r_hi.append(mask * hi)
        r_lo.append(mask * lo)
    return DF32(hi=jnp.stack(r_hi), lo=jnp.stack(r_lo))


def df_residual_const_packed(w33, b4_df, u4_df, m: int):
    """r = b - A u in double-float32 on color-packed fields (constant
    stencil): the packed analog of ops/doublefloat.df_residual_const.
    Weights enter as exact (hi, lo) f32 pairs; with the field packed the
    residual, like the sweeps, evaluates each point's stencil exactly
    once. Lets the defect-correction solve loop keep its state packed
    end-to-end — pack/unpack happen once per solve, not per step (the
    odd-size relayouts they imply measured ~10-50x a sweep).

    Dispatches to the TwoSum-cascade fast path when all weights are
    powers of two (exact f32 products — true for Poisson on 2^k-1
    grids)."""
    import numpy as np

    from amg_jax.ops.doublefloat import (DF32, df_add, df_mul, df_neg,
                                         is_pow2_weights)

    if is_pow2_weights(w33):
        return _df_residual_pow2_packed(w33, b4_df, u4_df, m)

    r_hi, r_lo = [], []
    for pj, pi in COLORS:
        a = 2 * pj + pi
        acc = DF32.from_f32(jnp.zeros_like(u4_df.hi[a]))
        terms = [((1, 1), a, (0, 0))] + _neighbors(pj, pi)
        for (wj, wi), src, (sJ, sI) in terms:
            w = w33[wj][wi]
            if w == 0.0:
                continue
            w_hi = float(np.float32(w))
            w_lo = float(np.float32(w - w_hi))
            x = DF32(hi=_shift(u4_df.hi[src], sJ, sI),
                     lo=_shift(u4_df.lo[src], sJ, sI))
            acc = df_add(acc, df_mul(
                DF32(hi=jnp.float32(w_hi), lo=jnp.float32(w_lo)), x))
        r = df_add(DF32(hi=b4_df.hi[a], lo=b4_df.lo[a]), df_neg(acc))
        mask = _valid(pj, pi, m, u4_df.hi.dtype)
        r_hi.append(mask * r.hi)
        r_lo.append(mask * r.lo)
    return DF32(hi=jnp.stack(r_hi), lo=jnp.stack(r_lo))


def prolong_add_packed(u4: jnp.ndarray, uc: jnp.ndarray, m: int
                       ) -> jnp.ndarray:
    """u4 += P uc for the bilinear P (coarse side m), color-packed: each
    quarter's correction is a sum of <=4 unit-shifted reads of the coarse
    field (equals prolong_mm on the unpacked field)."""
    M = m + 1
    U = jnp.zeros((M, M), dtype=uc.dtype).at[:m, :m].set(uc)
    dtype = u4.dtype
    c11 = U
    c01 = 0.5 * (_shift(U, -1, 0) + U)
    c10 = 0.5 * (_shift(U, 0, -1) + U)
    c00 = 0.25 * (_shift(U, -1, -1) + _shift(U, -1, 0)
                  + _shift(U, 0, -1) + U)
    for a, corr, (pj, pi) in ((0, c00, (0, 0)), (1, c01, (0, 1)),
                              (2, c10, (1, 0)), (3, c11, (1, 1))):
        u4 = u4.at[a].set(u4[a] + _valid(pj, pi, m, dtype) * corr)
    return u4
