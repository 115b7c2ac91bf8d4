"""Distributed structured multigrid: row-partitioned V-cycles over a device
mesh with halo exchange and coarse-level agglomeration.

This supplies the parallelism layer the reference lacks entirely (SURVEY.md
§2/§5): the 2-D grid is partitioned into contiguous row slabs (the j / x
direction — contiguous dof blocks under the reference's lexicographic
ordering, grid.hpp:88-98) across a 1-D ``jax.sharding.Mesh`` axis. Every
level op (four-color GS sweep, residual, restriction, prolongation) runs
inside one ``shard_map`` program and communicates only single-row halos with
ring neighbors via ``lax.ppermute``, which XLA lowers to NCCL point-to-point
transfers on a GPU mesh.

As levels shrink, rows-per-device halves; once a level's slab would drop
below 2 rows the hierarchy switches to *agglomerated* (replicated) levels:
the coarse rhs is ``all_gather``-ed and the remaining sub-hierarchy
(including the dense coarsest LU solve, multigrid.hpp:240-243) is computed
redundantly on every device — the AMG analog of gathering shards onto one
host (SURVEY.md §2 "coarse-level agglomeration").

Layout invariants (set up by ``build_dist_hierarchy``):
  * sharded level l has padded row count ``n_pad_l = D * B_l`` with ``B_l``
    even, so local row parity equals global parity and the four-color
    sub-lattices align across devices without index arithmetic;
  * ``B_{l+1} = B_l / 2`` so a device's coarse slab depends only on its own
    fine slab plus one halo row (restriction) / one coarse halo row
    (prolongation);
  * padded rows carry identity diagonal and zero rhs, so they stay zero
    through every sweep.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from amg_jax.models import poisson
from amg_jax.multigrid import SolveResult
from amg_jax.ops.transfer import linear_interp_1d
from amg_jax.sparse.stencil import Stencil2D, W2D
from amg_jax.structured import StencilHierarchy, max_levels_for_side

AXIS = "x"


# ---------------------------------------------------------------------------
# Local (per-shard) kernels. All take the device's (B, n) slab.


def _halo(u_loc, D: int):
    """Exchange boundary rows with ring neighbors: returns (top, bot) halo
    rows — zeros at the outer edges (Dirichlet-consistent)."""
    if D == 1:
        z = jnp.zeros_like(u_loc[:1])
        return z, z
    top = lax.ppermute(u_loc[-1:], AXIS, [(i, i + 1) for i in range(D - 1)])
    bot = lax.ppermute(u_loc[:1], AXIS, [(i + 1, i) for i in range(D - 1)])
    return top, bot


def _padded(u_loc, D: int):
    """(B, n) slab -> (B+2, n+2) with neighbor halos and zero LR columns."""
    top, bot = _halo(u_loc, D)
    return jnp.pad(jnp.concatenate([top, u_loc, bot], axis=0),
                   ((0, 0), (1, 1)))


def _matvec_local(c_loc, u_loc, D: int):
    """9-point SpMV on the slab (c_loc: (3,3,B,n))."""
    B, n = u_loc.shape
    up = _padded(u_loc, D)
    out = jnp.zeros_like(u_loc)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            out = out + c_loc[dj + 1, di + 1] * lax.slice(
                up, (1 + dj, 1 + di), (1 + dj + B, 1 + di + n))
    return out


_COLORS = ((0, 0), (0, 1), (1, 0), (1, 1))


# ---------------------------------------------------------------------------
# Ghost-strip (one-exchange-per-sweep) kernels for constant-stencil levels.
#
# The per-color-step halo exchange below (_gs4_sweep_local) blocks on a
# ppermute before EVERY color step — 8 exchanges per symmetric sweep, the
# scaling bottleneck. For constant-stencil levels we instead apply
# ghost-zone temporal blocking ACROSS DEVICES:
# exchange one G-row ghost strip of (u, b) up front (a single ppermute pair),
# run all color steps on the extended slab in-registers, and discard the
# ghost rows the steps invalidated. G = steps + 2 keeps two extra ghost rows
# valid after the sweep so the residual + restriction that follow reuse the
# SAME exchange — zero additional communication on the V-cycle down-leg.


def _conv9_const(w33, x):
    """9-point constant-stencil apply with zero padding on all sides.
    Rows 0 and R-1 of the result see zero padding above/below — callers
    only consume rows whose true neighbors are present."""
    R, n = x.shape
    xp = jnp.pad(x, 1)
    out = jnp.zeros_like(x)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            w = w33[dj + 1][di + 1]
            if w == 0.0:
                continue
            out = out + w * lax.slice(
                xp, (1 + dj, 1 + di), (1 + dj + R, 1 + di + n))
    return out


def _exchange_strips(u_loc, b_loc, G: int, D: int):
    """One ghost-strip exchange: returns (u_ext, b_ext) with G neighbor
    rows above and below (zeros at the ring edges). u and b strips ride the
    same ppermute (one collective per direction per sweep).

    When G > B (tiny slabs), the strip spans ceil(G/B) neighbor slabs and
    the exchange runs that many hops — still independent of the number of
    color steps, unlike the per-step exchange it replaces."""
    B, n = u_loc.shape
    z = jnp.zeros((G, n), dtype=u_loc.dtype)
    if D == 1:
        return (jnp.concatenate([z, u_loc, z], axis=0),
                jnp.concatenate([z, b_loc, z], axis=0))
    hops = -(-G // B)
    stack = jnp.concatenate([u_loc, b_loc], axis=0)  # (2B, n)
    above, below = [], []  # slabs of devices d-h (h=1..hops) and d+h
    for h in range(1, hops + 1):
        above.append(lax.ppermute(
            stack, AXIS, [(i, i + h) for i in range(D - h)]))
        below.append(lax.ppermute(
            stack, AXIS, [(i + h, i) for i in range(D - h)]))
    # rows above this slab, nearest last: [d-hops; ...; d-1]
    top_u = jnp.concatenate([z[:B]] + [s[:B] for s in above[::-1]], axis=0)
    top_b = jnp.concatenate([z[:B]] + [s[B:] for s in above[::-1]], axis=0)
    bot_u = jnp.concatenate([s[:B] for s in below] + [z[:B]], axis=0)
    bot_b = jnp.concatenate([s[B:] for s in below] + [z[:B]], axis=0)
    u_ext = jnp.concatenate([top_u[-G:], u_loc, bot_u[:G]], axis=0)
    b_ext = jnp.concatenate([top_b[-G:], b_loc, bot_b[:G]], axis=0)
    return u_ext, b_ext


def _masked_steps_const(w33, x, bx, row0_g, side: int, sweeps: int,
                        omega: float, symmetric: bool):
    """Core masked color steps on an arbitrary row window.

    x/bx: (R, n) slabs whose row r is global row ``row0_g + r`` (traced
    offset). Rows outside [0, side) are masked off (zero-padding boundary
    semantics); rows near the window edges are left invalid for the caller
    to discard (ghost-zone blocking)."""
    R, n = x.shape
    row_g = jax.lax.broadcasted_iota(jnp.int32, (R, n), 0) + row0_g
    col_g = jax.lax.broadcasted_iota(jnp.int32, (R, n), 1)
    valid = (row_g >= 0) & (row_g < side)
    row_par = row_g % 2
    col_par = col_g % 2
    inv_diag = 1.0 / w33[1][1]
    order = list(_COLORS)
    if symmetric:
        order = order + order[::-1]
    for _ in range(sweeps):
        for pj, pi in order:
            r = bx - _conv9_const(w33, x)
            mask = (row_par == pj) & (col_par == pi) & valid
            x = x + jnp.where(mask, omega * r * inv_diag, 0.0)
    return x


def _gs4_sweep_ghost_const(w33, u_loc, b_loc, side: int, sweeps: int,
                           omega: float, symmetric: bool, D: int):
    """``sweeps`` four-color GS sweeps with ONE ghost-strip exchange.

    Returns (u_ext, b_ext, G): extended (B + 2G, n) slabs where rows
    [G-2, G+B+2) of u_ext hold exactly the values the global masked sweep
    (sparse/stencil.py gs4_sweep_masked) would produce — each color step
    invalidates one ghost row per side, and G = steps*sweeps + 2 leaves a
    2-row margin valid for the residual/restriction that follow."""
    B, n = u_loc.shape
    steps = (8 if symmetric else 4) * sweeps
    G = steps + 2
    if G % 2:
        G += 1  # keep parity alignment
    u_ext, b_ext = _exchange_strips(u_loc, b_loc, G, D)
    dev = lax.axis_index(AXIS)
    u_ext = _masked_steps_const(w33, u_ext, b_ext, dev * B - G, side,
                                sweeps, omega, symmetric)
    return u_ext, b_ext, G


def _gs4_sweep_overlap_const(w33, u_loc, b_loc, side: int, sweeps: int,
                             omega: float, symmetric: bool, D: int):
    """Compute-OVERLAPPED variant of the ghost-strip sweep.

    The bulk of the slab never needs neighbor data through M = 8*sweeps
    color steps, so it is swept from purely local inputs while the
    ghost-strip ppermute is in flight; only two thin boundary bands
    (3M+2 rows each) consume the received strips. Expressing the sweep this
    way removes the data dependency collective -> interior compute, letting
    XLA's async collective-permute scheduler hide the exchange entirely
    behind the interior sweep (the NCCL p2p/compute-overlap pattern named
    in SURVEY.md §2/§5). Bitwise-equal
    outputs to _gs4_sweep_ghost_const.

    Returns (u_ext, b_ext, G) in the same layout as the ghost sweep.
    """
    B, n = u_loc.shape
    M = (8 if symmetric else 4) * sweeps
    G = M + 2
    if G % 2:
        G += 1
    if B < 2 * M:  # slab too thin to split — bands would cover it anyway
        return _gs4_sweep_ghost_const(w33, u_loc, b_loc, side, sweeps,
                                      omega, symmetric, D)
    dev = lax.axis_index(AXIS)
    row0 = dev * B
    # exchange launches first; nothing below depends on it until the bands
    u_ext_in, b_ext_in = _exchange_strips(u_loc, b_loc, G, D)
    # interior: local-only sweep, valid on rows [M, B-M)
    u_local = _masked_steps_const(w33, u_loc, b_loc, row0, side, sweeps,
                                  omega, symmetric)
    # top band: final local rows [-G, M) (uses top ghosts + u_loc[:2M))
    H = G + 2 * M
    top_in_u = u_ext_in[:H]
    top_in_b = b_ext_in[:H]
    top = _masked_steps_const(w33, top_in_u, top_in_b, row0 - G, side,
                              sweeps, omega, symmetric)
    # bottom band: final local rows [B-M, B+G)
    bot_in_u = u_ext_in[B + 2 * G - H:]
    bot_in_b = b_ext_in[B + 2 * G - H:]
    bot = _masked_steps_const(w33, bot_in_u, bot_in_b,
                              row0 + B + G - H, side, sweeps, omega,
                              symmetric)
    # assemble the extended result: [-G, M) from top band, [M, B-M) from
    # the local sweep, [B-M, B+G) from the bottom band. Only rows
    # [-2, B+2) are contract-valid (same as the ghost sweep).
    u_ext = jnp.concatenate([top[:G + M], u_local[M:B - M],
                             bot[H - (G + M):]], axis=0)
    return u_ext, b_ext_in, G


def _gs4_sweep_packed_const(w33, u_loc, b_loc, side: int, sweeps: int,
                            omega: float, symmetric: bool, D: int):
    """Ghost-strip sweep whose color steps run COLOR-PACKED — the
    distributed form of the single-chip production smoother
    (sparse/packed.py): after the one strip exchange, the extended slab
    is packed into parity quarters (two cheap single-axis reshuffles),
    the 8 color steps evaluate the stencil only at the points they
    update (4x fewer evaluations than the full-width masked steps), and
    the slab is unpacked for the down-leg residual/restriction. Same
    (u_ext, b_ext, G) contract and same iterates as
    _gs4_sweep_ghost_const up to fp reassociation."""
    from amg_jax.sparse.packed import (pack_rect, packed_steps_window,
                                       unpack_rect)

    B, n = u_loc.shape
    steps = (8 if symmetric else 4) * sweeps
    G = steps + 2
    if G % 2:
        G += 1
    u_ext, b_ext = _exchange_strips(u_loc, b_loc, G, D)
    dev = lax.axis_index(AXIS)
    row0 = dev * B - G  # even: B and G are both even
    m = (n - 1) // 2
    u4 = pack_rect(u_ext, m)
    b4 = pack_rect(b_ext, m)
    u4 = packed_steps_window(w33, u4, b4, row0, side, sweeps, omega,
                             symmetric)
    return unpack_rect(u4, m), b_ext, G


# ---------------------------------------------------------------------------
# Ghost-strip kernels for VARIABLE-coefficient levels.
#
# The coefficient planes are loop-invariant, so their ghost strips are
# exchanged ONCE (XLA hoists the ppermute out of solve while-loops) and the
# per-sweep communication drops to the same single (u, b) strip exchange the
# constant path uses — instead of one exchange before every color step
# (8 ppermute pairs per symmetric sweep, the r1 scaling bottleneck, which
# remained the var-level behavior through r3).


def _exchange_planes(c_loc, G: int, D: int):
    """(3, 3, B, n) coefficient planes -> (3, 3, B+2G, n) with neighbor
    ghost strips (zeros at the ring edges — the Dirichlet boundary).
    Multi-hop when G > B, mirroring _exchange_strips."""
    B, n = c_loc.shape[-2:]
    z = jnp.zeros(c_loc.shape[:2] + (G, n), dtype=c_loc.dtype)
    if D == 1 or G == 0:
        return jnp.concatenate([z, c_loc, z], axis=2)
    hops = -(-G // B)
    above, below = [], []
    for h in range(1, hops + 1):
        above.append(lax.ppermute(
            c_loc, AXIS, [(i, i + h) for i in range(D - h)]))
        below.append(lax.ppermute(
            c_loc, AXIS, [(i + h, i) for i in range(D - h)]))
    top = jnp.concatenate([z[:, :, :B]] + above[::-1], axis=2)
    bot = jnp.concatenate(below + [z[:, :, :B]], axis=2)
    return jnp.concatenate([top[:, :, top.shape[2] - G:], c_loc,
                            bot[:, :, :G]], axis=2)


def _conv9_window(c_ext, x):
    """9-point A x on an extended row window with matching per-row
    coefficient planes (c_ext: (3, 3, R, n), x: (R, n)); zero padding
    supplies the window/boundary truncation."""
    R, n = x.shape
    xp = jnp.pad(x, 1)
    out = jnp.zeros_like(x)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            out = out + c_ext[dj + 1, di + 1] * lax.slice(
                xp, (1 + dj, 1 + di), (1 + dj + R, 1 + di + n))
    return out


def _masked_steps_var(c_ext, x, bx, sweeps: int, omega: float,
                      symmetric: bool):
    """Masked color steps on an extended row window with variable
    coefficients (the _masked_steps_var analog of _masked_steps_const).
    Rows with zero diagonal — window padding beyond the ring edges and
    grid-padding rows — never update (the reference's zero-diagonal guard,
    smoother.hpp:136). Local parity equals global parity because B and G
    are even."""
    R, n = x.shape
    row_par = jax.lax.broadcasted_iota(jnp.int32, (R, n), 0) % 2
    col_par = jax.lax.broadcasted_iota(jnp.int32, (R, n), 1) % 2
    diag = c_ext[1, 1]
    inv = jnp.where(diag != 0, 1.0 / jnp.where(diag != 0, diag, 1.0), 0.0)
    order = list(_COLORS)
    if symmetric:
        order = order + order[::-1]
    for _ in range(sweeps):
        for pj, pi in order:
            r = bx - _conv9_window(c_ext, x)
            mask = (row_par == pj) & (col_par == pi)
            x = x + jnp.where(mask, (omega * r) * inv, 0.0)
    return x


def _gs4_sweep_ghost_var(c_ext, u_loc, b_loc, sweeps: int, omega: float,
                         symmetric: bool, D: int, G: int):
    """Variable-coefficient ghost-strip sweep: ONE (u, b) strip exchange
    per ``sweeps`` sweeps, color steps on the extended slab (temporal
    blocking; same contract as _gs4_sweep_ghost_const — rows [G-2, G+B+2)
    of the result are exact when G >= steps*sweeps + 2)."""
    u_ext, b_ext = _exchange_strips(u_loc, b_loc, G, D)
    u_ext = _masked_steps_var(c_ext, u_ext, b_ext, sweeps, omega,
                              symmetric)
    return u_ext, b_ext


def _matvec_const(w33, u_loc, side: int, B: int, D: int):
    """Constant-stencil SpMV on the slab: 1-row halo + conv; padding rows
    (global row >= side) act as identity (u there is kept zero)."""
    top, bot = _halo(u_loc, D)
    x = jnp.concatenate([top, u_loc, bot], axis=0)
    av = _conv9_const(w33, x)[1:1 + B]
    dev = lax.axis_index(AXIS)
    row_g = jax.lax.broadcasted_iota(jnp.int32, u_loc.shape, 0) + dev * B
    return jnp.where(row_g < side, av, u_loc)


def _restrict_from_ext(r01, Bc: int, nc: int, nc_real: int, D: int):
    """Full-weighting restriction from r at slab rows 0..B (B+1 rows,
    already available from the ghost-strip sweep — no halo exchange)."""
    w = jnp.asarray(W2D, dtype=r01.dtype)
    out = jnp.zeros((Bc, nc), dtype=r01.dtype)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            out = out + w[dj + 1, di + 1] * lax.slice(
                r01, (1 + dj, 1 + di),
                (1 + dj + 2 * Bc - 1, 1 + di + 2 * nc - 1), (2, 2))
    dev = lax.axis_index(AXIS)
    grow = dev * Bc + jnp.arange(Bc)
    return jnp.where((grow < nc_real)[:, None], out, 0)


def _df_residual_const(w33, b_df, u_df, side: int, B: int, D: int):
    """r = b - A u on the sharded slab in double-float32 (ops/doublefloat),
    for a constant-stencil level. The 1-row halo carries hi and lo rows in
    one ppermute pair; the 9 weights enter as exact (hi, lo) constant
    pairs, so the residual matches the f64 one to ~2^-48 relative — the
    piece that lets the DISTRIBUTED solve reach the reference's 1e-9-scale
    tolerances (testlib.cpp:158) without emulated-f64 matvecs."""
    from amg_jax.ops.doublefloat import DF32, df_add, df_mul, df_neg

    n = u_df.hi.shape[1]
    if D == 1:
        z = jnp.zeros((1, n), dtype=u_df.hi.dtype)
        top_h = bot_h = top_l = bot_l = z
    else:
        down = jnp.concatenate([u_df.hi[-1:], u_df.lo[-1:]], axis=0)
        up = jnp.concatenate([u_df.hi[:1], u_df.lo[:1]], axis=0)
        top = lax.ppermute(down, AXIS, [(i, i + 1) for i in range(D - 1)])
        bot = lax.ppermute(up, AXIS, [(i + 1, i) for i in range(D - 1)])
        top_h, top_l = top[:1], top[1:]
        bot_h, bot_l = bot[:1], bot[1:]
    xh = jnp.pad(jnp.concatenate([top_h, u_df.hi, bot_h], axis=0),
                 ((0, 0), (1, 1)))
    xl = jnp.pad(jnp.concatenate([top_l, u_df.lo, bot_l], axis=0),
                 ((0, 0), (1, 1)))
    acc = DF32.from_f32(jnp.zeros_like(u_df.hi))
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            w = w33[dj + 1][di + 1]
            if w == 0.0:
                continue
            w_hi = float(np.float32(w))
            w_lo = float(np.float32(w - w_hi))
            sl = lambda z_: lax.slice(z_, (1 + dj, 1 + di),
                                      (1 + dj + B, 1 + di + n))
            term = df_mul(DF32(hi=jnp.float32(w_hi), lo=jnp.float32(w_lo)),
                          DF32(hi=sl(xh), lo=sl(xl)))
            acc = df_add(acc, term)
    r = df_add(b_df, df_neg(acc))
    # padding rows (global row >= side) carry zero residual
    dev = lax.axis_index(AXIS)
    row_g = jax.lax.broadcasted_iota(jnp.int32, u_df.hi.shape, 0) + dev * B
    keep = row_g < side
    return DF32(hi=jnp.where(keep, r.hi, 0.0),
                lo=jnp.where(keep, r.lo, 0.0))


def _gs4_sweep_local_const(w33, u_loc, b_loc, side: int, B: int,
                           omega: float, symmetric: bool, D: int):
    """Constant-stencil analog of _gs4_sweep_local: one halo exchange per
    color step (halo='step' mode), stencil weights from the static w33
    instead of coefficient planes. Padding rows (global row >= side) act
    as identity via _matvec_const, so their residual is zero and they
    never update."""
    _, n = u_loc.shape
    row_par = jax.lax.broadcasted_iota(jnp.int32, u_loc.shape, 0) % 2
    col_par = jax.lax.broadcasted_iota(jnp.int32, u_loc.shape, 1) % 2
    inv_diag = 1.0 / w33[1][1]
    order = list(_COLORS)
    if symmetric:
        order = order + order[::-1]
    for pj, pi in order:
        r = b_loc - _matvec_const(w33, u_loc, side, B, D)
        mask = ((row_par == pj) & (col_par == pi)).astype(u_loc.dtype)
        u_loc = u_loc + (omega * mask) * (r * inv_diag)
    return u_loc


def _gs4_sweep_local(c_loc, u_loc, b_loc, omega: float, symmetric: bool,
                     D: int):
    """Sharded four-color GS sweep as full-width masked updates (see
    sparse/stencil.py gs4_sweep_masked). Local
    parity equals global parity because block sizes are even, so the color
    masks are compile-time iota patterns. One halo exchange per color step
    keeps neighbor slabs current."""
    B, n = u_loc.shape
    row_par = jax.lax.broadcasted_iota(jnp.int32, (B, n), 0) % 2
    col_par = jax.lax.broadcasted_iota(jnp.int32, (B, n), 1) % 2
    inv_diag = 1.0 / c_loc[1, 1]
    order = list(_COLORS)
    if symmetric:
        order = order + order[::-1]
    for pj, pi in order:
        r = b_loc - _matvec_local(c_loc, u_loc, D)
        mask = ((row_par == pj) & (col_par == pi)).astype(u_loc.dtype)
        u_loc = u_loc + (omega * mask) * (r * inv_diag)
    return u_loc


def _restrict_local(r_loc, Bc: int, nc: int, nc_real: int, D: int):
    """Full-weighting restriction of the slab: coarse slab (Bc, nc_real)
    padded-masked to rows beyond the real coarse grid."""
    B, n = r_loc.shape
    _, bot = _halo(r_loc, D)
    rext = jnp.concatenate([r_loc, bot], axis=0)  # (B+1, n)
    w = jnp.asarray(W2D, dtype=r_loc.dtype)
    out = jnp.zeros((Bc, nc), dtype=r_loc.dtype)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            out = out + w[dj + 1, di + 1] * lax.slice(
                rext, (1 + dj, 1 + di),
                (1 + dj + 2 * Bc - 1, 1 + di + 2 * nc - 1), (2, 2))
    # zero the padded coarse rows (global row >= nc_real)
    dev = lax.axis_index(AXIS)
    grow = dev * Bc + jnp.arange(Bc)
    return jnp.where((grow < nc_real)[:, None], out, 0)


def _prolong_local(uc_loc, B: int, n: int, D: int):
    """Bilinear prolongation onto the fine slab from the coarse slab +
    top coarse halo row."""
    Bc, nc = uc_loc.shape
    topc, _ = _halo(uc_loc, D)
    z = jnp.zeros((B + 2, n + 2), dtype=uc_loc.dtype)
    z = z.at[0, 2:2 * nc + 1:2].set(topc[0])
    z = z.at[2:2 * Bc + 1:2, 2:2 * nc + 1:2].set(uc_loc)
    return _prolong_from_z(z, B, n, uc_loc.dtype)


def _prolong_from_z(z, B: int, n: int, dtype):
    w = jnp.asarray(W2D, dtype=dtype)
    out = jnp.zeros((B, n), dtype=dtype)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            out = out + w[dj + 1, di + 1] * lax.slice(
                z, (1 + dj, 1 + di), (1 + dj + B, 1 + di + n))
    return out


def _prolong_from_replicated(uc_full, B: int, n: int, Bc: int, D: int):
    """Prolongate a replicated coarse field onto this device's fine slab:
    slice the local coarse block plus its top halo row out of the full
    field, then apply the bilinear kernel."""
    nc = uc_full.shape[1]
    n_pad_c = D * Bc
    dev = lax.axis_index(AXIS)
    # pad: 1 zero row on top (halo of device 0), zeros to n_pad_c below
    ucp = jnp.pad(uc_full, ((1, n_pad_c - uc_full.shape[0]), (0, 0)))
    # rows [dev*Bc - 1, dev*Bc + Bc) of the coarse grid == ucp rows
    # [dev*Bc, dev*Bc + Bc + 1)
    start = (dev * Bc).astype(jnp.int32)
    block = lax.dynamic_slice(ucp, (start, jnp.int32(0)), (Bc + 1, nc))
    z = jnp.zeros((B + 2, n + 2), dtype=uc_full.dtype)
    z = z.at[0, 2:2 * nc + 1:2].set(block[0])
    z = z.at[2:2 * Bc + 1:2, 2:2 * nc + 1:2].set(block[1:])
    return _prolong_from_z(z, B, n, uc_full.dtype)


# ---------------------------------------------------------------------------
# Hierarchy construction


@dataclasses.dataclass(frozen=True)
class DistConfig:
    n_devices: int
    sides: tuple            # grid side per level (all levels)
    blocks: tuple           # B_l rows/device for sharded levels
    n_sharded: int          # number of sharded levels
    pre_sweeps: int = 1
    post_sweeps: int = 1
    omega: float = 1.0
    symmetric: bool = True
    # per sharded level: 3x3 constant-stencil weight tuple, or None when the
    # level has variable coefficients (→ per-color-step halo fallback)
    w33s: tuple = ()
    # 'overlap' = one ghost-strip exchange per sweep, hidden behind the
    # interior compute (const levels only; default); 'sweep' = same
    # exchange without the overlap restructuring; 'packed' = the 'sweep'
    # exchange with color-packed steps; 'step' = reference-style exchange
    # before every color step
    halo: str = "overlap"


def plan_distribution(side: int, n_levels: int, n_devices: int,
                      min_rows: int = 2):
    """Choose how many levels stay sharded and the (even, halving) per-device
    block sizes. Returns (sides, blocks, n_sharded)."""
    sides = [side]
    for _ in range(n_levels - 1):
        sides.append((sides[-1] - 1) // 2)
    # Most sharded levels possible: B_l = B_0/2^l must stay >= min_rows and
    # at least the coarsest level must be replicated.
    best = None
    for Ls in range(n_levels - 1, 0, -1):
        B0 = -(-side // n_devices)  # ceil
        mult = 1 << Ls
        B0 = -(-B0 // mult) * mult  # round up to multiple of 2^Ls
        if B0 // (1 << (Ls - 1)) >= min_rows:
            best = (Ls, B0)
            break
    if best is None:
        return tuple(sides), (), 0
    Ls, B0 = best
    blocks = tuple(B0 >> l for l in range(Ls))
    return tuple(sides), blocks, Ls


def build_dist_hierarchy(side: int, n_levels: int | None = None,
                         n_devices: int | None = None, dtype=jnp.float32,
                         A_fine=None, force_var: bool = False):
    """Host-side setup: padded sharded coefficient planes + replicated
    coarse sub-hierarchy (Galerkin RAP chain as in multigrid.hpp:211-243).

    Constant-stencil levels (the Poisson/Galerkin case — detected exactly)
    carry their 9 weights as static config instead of (3,3,n_pad,n) plane
    arrays: no coefficient memory, no coefficient HBM traffic, and the
    ghost-strip sweep needs no coefficient halos. ``force_var`` keeps the
    plane arrays anyway (per-color-step halo path, for equivalence tests).
    """
    import scipy.sparse as sp
    import jax.scipy.linalg as jsl

    if n_devices is None:
        n_devices = len(jax.devices())
    if n_levels is None:
        n_levels = max_levels_for_side(side)
    sides, blocks, Ls = plan_distribution(side, n_levels, n_devices)
    if A_fine is None:
        A_fine = poisson.laplacian_scipy(side)

    mats = [A_fine.tocsr()]
    for l in range(n_levels - 1):
        n = sides[l]
        nc = sides[l + 1]
        P1 = linear_interp_1d(n, nc)
        P2 = sp.kron(P1, P1).tocsr()
        mats.append((P2.T @ (mats[-1] @ P2)).tocsr())

    # Sharded levels: pad rows to D*B_l, identity diagonal on padding.
    # Constant levels store a placeholder scalar (replicated) instead.
    sharded_coeffs = []
    w33s = []
    for l in range(Ls):
        n = sides[l]
        S = Stencil2D.from_scipy(mats[l], n, dtype=dtype)
        w33s.append(None if force_var else S.w33)
        if w33s[-1] is not None:
            sharded_coeffs.append(jnp.zeros((1,), dtype=dtype))
            continue
        c = np.asarray(S.c)
        n_pad = n_devices * blocks[l]
        cp = np.zeros((3, 3, n_pad, n), dtype=c.dtype)
        cp[:, :, :n, :] = c
        cp[1, 1, n:, :] = 1.0  # identity rows on padding
        sharded_coeffs.append(jnp.asarray(cp))

    # Replicated coarse sub-hierarchy (levels Ls..n_levels-1).
    from amg_jax.ops.transfer import linear_interp_1d as _li1
    from amg_jax.sparse.stencil import color_masks as _cm

    repl_levels = tuple(Stencil2D.from_scipy(mats[l], sides[l], dtype=dtype)
                        for l in range(Ls, n_levels))
    coarse_dense = jnp.asarray(mats[-1].toarray(), dtype=dtype)
    lu, piv = jsl.lu_factor(coarse_dense)
    sub_sides = tuple(sides[Ls:])
    sub_P1s = tuple(jnp.asarray(_li1(sub_sides[i], sub_sides[i + 1]
                                     ).toarray(), dtype=dtype)
                    for i in range(len(sub_sides) - 1))
    sub_masks = tuple(_cm(s, dtype) for s in sub_sides)
    sub_hier = StencilHierarchy(levels=repl_levels, coarse_lu=lu,
                                coarse_piv=piv, P1s=sub_P1s,
                                masks=sub_masks,
                                sides=sub_sides, smoother="masked")
    cfg = DistConfig(n_devices=n_devices, sides=tuple(sides),
                     blocks=tuple(blocks), n_sharded=Ls,
                     w33s=tuple(w33s))
    return cfg, tuple(sharded_coeffs), sub_hier


# ---------------------------------------------------------------------------
# The shard_map V-cycle


def _vcycle_local(cfg: DistConfig, sharded_coeffs, sub_hier: StencilHierarchy,
                  u_loc, b_loc):
    """Per-device body of one V-cycle. u_loc/b_loc: (B_0, n_0) slabs."""
    from amg_jax.structured import vcycle_stencil

    D = cfg.n_devices
    Ls = cfg.n_sharded
    us = [None] * Ls
    bs = [None] * Ls
    us[0], bs[0] = u_loc, b_loc

    ghost_fns = {"sweep": _gs4_sweep_ghost_const,
                 "overlap": _gs4_sweep_overlap_const,
                 "packed": _gs4_sweep_packed_const}
    ghost_fn = ghost_fns.get(cfg.halo)

    def G_of(sweeps):
        g = (8 if cfg.symmetric else 4) * sweeps + 2
        return g + (g % 2)

    # variable-coefficient levels under any ghost-strip mode: exchange the
    # loop-invariant coefficient-plane strips ONCE (hoisted out of solve
    # loops by XLA) so each sweep pays the same single (u, b) exchange as
    # the const path — not 2C ppermutes. One G serves
    # pre-smooth, residual, and post-smooth (a larger ghost is always
    # valid).
    var_ext = {}
    if ghost_fn is not None:
        Gv = max(G_of(cfg.pre_sweeps), G_of(cfg.post_sweeps))
        for l in range(Ls):
            if cfg.w33s[l] is None:
                var_ext[l] = _exchange_planes(sharded_coeffs[l], Gv, D)

    def smooth_only(l, u, b, sweeps):
        """Post-smooth: ghost-strip path (1 exchange/sweep; 'overlap'
        additionally hides it behind interior compute) on constant levels,
        ghost-strip var path on variable levels, per-color-step exchange
        under halo='step'."""
        w33 = cfg.w33s[l]
        B = cfg.blocks[l]
        if ghost_fn is not None and w33 is not None:
            u_ext, _, G = ghost_fn(
                w33, u, b, cfg.sides[l], sweeps, cfg.omega, cfg.symmetric, D)
            return u_ext[G:G + B]
        if l in var_ext:
            u_ext, _ = _gs4_sweep_ghost_var(var_ext[l], u, b, sweeps,
                                            cfg.omega, cfg.symmetric, D,
                                            Gv)
            return u_ext[Gv:Gv + B]
        for _ in range(sweeps):
            if w33 is not None:  # halo='step' on a constant level
                u = _gs4_sweep_local_const(w33, u, b, cfg.sides[l], B,
                                           cfg.omega, cfg.symmetric, D)
            else:
                u = _gs4_sweep_local(sharded_coeffs[l], u, b, cfg.omega,
                                     cfg.symmetric, D)
        return u

    # sharded down-leg (multigrid.hpp:265-284 leg order)
    for l in range(Ls):
        w33 = cfg.w33s[l]
        nc_real = cfg.sides[l + 1]
        Bc = cfg.blocks[l + 1] if l < Ls - 1 else cfg.blocks[l] // 2
        if ghost_fn is not None and w33 is not None:
            # one exchange covers pre-smooth + residual + restriction:
            # post-sweep ghost rows at distance <= 2 are still exact
            B = cfg.blocks[l]
            u_ext, b_ext, G = ghost_fn(
                w33, us[l], bs[l], cfg.sides[l], cfg.pre_sweeps, cfg.omega,
                cfg.symmetric, D)
            us[l] = u_ext[G:G + B]
            r01 = (b_ext - _conv9_const(w33, u_ext))[G:G + B + 1]
            # padding rows (global row >= side) must carry zero residual
            dev = lax.axis_index(AXIS)
            row_g = (jax.lax.broadcasted_iota(jnp.int32, r01.shape, 0)
                     + dev * B)
            r01 = jnp.where(row_g < cfg.sides[l], r01, 0.0)
            coarse_loc = _restrict_from_ext(r01, Bc, nc_real, nc_real, D)
        elif l in var_ext:
            # var ghost path: the same one-exchange-covers-everything
            # structure as the const branch above
            B = cfg.blocks[l]
            c_ext = var_ext[l]
            u_ext, b_ext = _gs4_sweep_ghost_var(
                c_ext, us[l], bs[l], cfg.pre_sweeps, cfg.omega,
                cfg.symmetric, D, Gv)
            us[l] = u_ext[Gv:Gv + B]
            r01 = (b_ext - _conv9_window(c_ext, u_ext))[Gv:Gv + B + 1]
            dev = lax.axis_index(AXIS)
            row_g = (jax.lax.broadcasted_iota(jnp.int32, r01.shape, 0)
                     + dev * B)
            r01 = jnp.where(row_g < cfg.sides[l], r01, 0.0)
            coarse_loc = _restrict_from_ext(r01, Bc, nc_real, nc_real, D)
        elif w33 is not None:
            # halo='step' on a constant level: per-color-step exchanges
            # with the static weights (no coefficient planes exist)
            B = cfg.blocks[l]
            for _ in range(cfg.pre_sweeps):
                us[l] = _gs4_sweep_local_const(w33, us[l], bs[l],
                                               cfg.sides[l], B, cfg.omega,
                                               cfg.symmetric, D)
            r = bs[l] - _matvec_const(w33, us[l], cfg.sides[l], B, D)
            # padding rows carry u = 0 and identity action, so r = 0 there
            coarse_loc = _restrict_local(r, Bc, nc_real, nc_real, D)
        else:
            c = sharded_coeffs[l]
            for _ in range(cfg.pre_sweeps):
                us[l] = _gs4_sweep_local(c, us[l], bs[l], cfg.omega,
                                         cfg.symmetric, D)
            r = bs[l] - _matvec_local(c, us[l], D)
            coarse_loc = _restrict_local(r, Bc, nc_real, nc_real, D)
        if l < Ls - 1:
            bs[l + 1] = coarse_loc
            us[l + 1] = jnp.zeros_like(coarse_loc)
        else:
            full = lax.all_gather(coarse_loc, AXIS, tiled=True)
            b_repl = full[:nc_real]
    # replicated (agglomerated) sub-hierarchy: one V-cycle pass from zero
    u_repl = vcycle_stencil(sub_hier, jnp.zeros_like(b_repl), b_repl,
                            cfg.pre_sweeps, cfg.post_sweeps, cfg.omega,
                            cfg.symmetric)
    # sharded up-leg (multigrid.hpp:291-302)
    for l in range(Ls - 1, -1, -1):
        B = cfg.blocks[l]
        n = cfg.sides[l]
        if l == Ls - 1:
            us[l] = us[l] + _prolong_from_replicated(u_repl, B, n, B // 2, D)
        else:
            us[l] = us[l] + _prolong_local(us[l + 1], B, n, D)
        us[l] = smooth_only(l, us[l], bs[l], cfg.post_sweeps)
    return us[0]


HALO_MODES = ("overlap", "sweep", "packed", "step")


def default_halo() -> str:
    """Halo mode when none is given: 'overlap' (two collectives per level
    per cycle, hidden behind interior compute) wherever the mesh's devices
    are accelerators; 'step' on a CPU mesh, where a ppermute is a memcpy
    and the ghost strip's extra compute dominates instead."""
    return "step" if jax.devices()[0].platform == "cpu" else "overlap"


class DistStructuredSolver:
    """Multi-device structured Poisson solver: the flagship scaling path.

    Builds the mesh, shards the finest fields as (n_pad, n) row slabs, and
    jits one shard_map program for the full V-cycle; ``solve`` runs the
    reference's outer stopping loop (multigrid.hpp:311-337) with a psum'd
    rss (the cross-shard reduction named in SURVEY.md §3.2).
    """

    def __init__(self, side: int, n_levels: int | None = None,
                 n_devices: int | None = None, dtype=jnp.float32,
                 pre_sweeps: int = 1, post_sweeps: int = 1,
                 omega: float = 1.0, symmetric: bool = True, A_fine=None,
                 halo: str | None = None, force_var: bool = False,
                 cycles_per_refine: int | None = None, config=None):
        # config.MeshConfig centralizes the distribution knobs; None
        # sentinels so a config never overrides an explicit argument
        # and cycles_per_refine is honored here exactly like in
        # EllDistSolver
        if config is not None:
            if n_devices is None:
                n_devices = config.n_devices
            if halo is None:
                halo = getattr(config, "halo", None)
            if cycles_per_refine is None:
                cycles_per_refine = getattr(config, "cycles_per_refine",
                                            None)
        if halo is None:
            halo = default_halo()
        if cycles_per_refine is None:
            cycles_per_refine = 2
        if halo not in HALO_MODES:
            raise ValueError(f"unknown halo mode {halo!r}; expected one "
                             f"of {HALO_MODES}")
        cfg, coeffs, sub_hier = build_dist_hierarchy(
            side, n_levels, n_devices, dtype, A_fine, force_var=force_var)
        cfg = dataclasses.replace(
            cfg, pre_sweeps=pre_sweeps, post_sweeps=post_sweeps,
            omega=omega, symmetric=symmetric, halo=halo)
        self.cfg = cfg
        self.dtype = dtype
        self.side = side
        D = cfg.n_devices
        self.mesh = jax.make_mesh((D,), (AXIS,),
                                  devices=jax.devices()[:D])
        self.coeffs = coeffs
        self.sub_hier = sub_hier
        self.n_pad = D * cfg.blocks[0] if cfg.n_sharded else side

        spec_field = P(AXIS, None)
        # constant levels hold a replicated placeholder scalar, not planes
        spec_coeffs = tuple(
            P() if cfg.w33s[l] is not None else P(None, None, AXIS, None)
            for l in range(cfg.n_sharded))

        def vc(coeffs_, sub_hier_, u, b):
            return _vcycle_local(cfg, coeffs_, sub_hier_, u, b)

        self._vcycle = jax.jit(jax.shard_map(
            vc, mesh=self.mesh,
            in_specs=(spec_coeffs, P(), spec_field, spec_field),
            out_specs=spec_field))

        def rss_fn(c0, u, b):
            if cfg.w33s and cfg.w33s[0] is not None:
                av = _matvec_const(cfg.w33s[0], u, cfg.sides[0],
                                   cfg.blocks[0], cfg.n_devices)
            else:
                av = _matvec_local(c0, u, cfg.n_devices)
            r = b - av
            return lax.psum(jnp.sum(r * r), AXIS)

        self._rss = jax.jit(jax.shard_map(
            rss_fn, mesh=self.mesh,
            in_specs=(spec_coeffs[0], spec_field, spec_field),
            out_specs=P()))

        # Distributed device-resident PCG: the whole
        # AMG-preconditioned CG iteration — SpMV, V-cycle preconditioner,
        # both inner products, rss convergence test — runs inside ONE
        # shard_map'd lax.while_loop; the inner products and the rss are
        # lax.psum'd partials over the row shards (the distributed form
        # promised at krylov.py:123-124). Works on const-stencil and
        # variable-coefficient fine levels. Extends the reference's plain
        # V-cycle outer loop (multigrid.hpp:311-337).
        w0_ = cfg.w33s[0] if cfg.w33s else None
        B0_ = cfg.blocks[0] if cfg.n_sharded else side
        side0_ = cfg.sides[0]

        def pcg_fn(coeffs_, sub_hier_, b_loc, tol, n_iters):
            def A_neg(x):  # SPD (negated) operator on the slab
                if w0_ is not None:
                    return -_matvec_const(w0_, x, side0_, B0_,
                                          cfg.n_devices)
                return -_matvec_local(coeffs_[0], x, cfg.n_devices)

            def precond(r):
                # z = -(V-cycle from zero on r); linear in r, keeps M SPD
                return -_vcycle_local(cfg, coeffs_, sub_hier_,
                                      jnp.zeros_like(r), r)

            def dot(a, b):
                return lax.psum(jnp.sum(a * b), AXIS)

            r0 = -b_loc
            z0 = precond(r0)

            def cond(s):
                _, _, _, _, it, err = s
                return (err > tol) & (it < n_iters)

            def body(s):
                u, r, z, p, it, _ = s
                Ap = A_neg(p)
                alpha = dot(r, z) / dot(p, Ap)
                u = u + alpha * p
                r_new = r - alpha * Ap
                z_new = precond(r_new)
                beta = dot(r_new, z_new) / dot(r, z)
                p = z_new + beta * p
                return (u, r_new, z_new, p, it + 1, dot(r_new, r_new))

            init = (jnp.zeros_like(b_loc), r0, z0, z0,
                    jnp.asarray(0, dtype=jnp.int32), dot(r0, r0))
            u, r, z, p, it, err = lax.while_loop(cond, body, init)
            return u, jnp.stack([err, it.astype(b_loc.dtype)])

        self._pcg_device = jax.jit(jax.shard_map(
            pcg_fn, mesh=self.mesh,
            in_specs=(spec_coeffs, P(), spec_field, P(), P()),
            out_specs=(spec_field, P())))

        # df32 defect-correction refine step (const fine level only): one
        # high-precision residual + rss, then cycles_per_refine f32
        # V-cycles on the residual, then u += e in df32. This is what lets
        # the distributed solve reach reference-grade (1e-9 in f64 /
        # 1e-7 f32-attainable) rss like the single-chip path.
        self.cycles_per_refine = cycles_per_refine
        if cfg.w33s and cfg.w33s[0] is not None:
            from amg_jax.ops.doublefloat import DF32, df_add_f32, df_rss

            w0 = cfg.w33s[0]
            B0 = cfg.blocks[0]
            side0 = cfg.sides[0]

            def refine_fn(coeffs_, sub_hier_, uh, ul, bh, bl):
                u_df = DF32(hi=uh, lo=ul)
                b_df = DF32(hi=bh, lo=bl)
                r = _df_residual_const(w0, b_df, u_df, side0, B0,
                                       cfg.n_devices)
                err = lax.psum(df_rss(r), AXIS)
                e = jnp.zeros_like(uh)
                for _ in range(cycles_per_refine):
                    e = _vcycle_local(cfg, coeffs_, sub_hier_, e, r.hi)
                u_next = df_add_f32(u_df, e)
                return u_next.hi, u_next.lo, err

            self._refine = jax.jit(jax.shard_map(
                refine_fn, mesh=self.mesh,
                in_specs=(spec_coeffs, P(), spec_field, spec_field,
                          spec_field, spec_field),
                out_specs=(spec_field, spec_field, P())))

            def solve_fn(coeffs_, sub_hier_, bh, bl, tol, n_refine):
                """Whole defect-correction solve as ONE device program
                (lax.while_loop with the collectives inside): no host
                round-trip per refinement step — the distributed analog of
                structured.solve_loop_df32. Lagged-error loop: the carried
                err is the rss BEFORE the latest correction, so it may run
                one refinement past convergence; exact rss recomputed
                after exit."""
                b_df = DF32(hi=bh, lo=bl)

                def residual(u_df):
                    return _df_residual_const(w0, b_df, u_df, side0, B0,
                                              cfg.n_devices)

                def cond(s):
                    _, _, err, it = s
                    return (err > tol) & (it < n_refine)

                def body(s):
                    uh, ul, _, it = s
                    r = residual(DF32(hi=uh, lo=ul))
                    err = lax.psum(df_rss(r), AXIS)
                    e = jnp.zeros_like(uh)
                    for _ in range(cycles_per_refine):
                        e = _vcycle_local(cfg, coeffs_, sub_hier_, e, r.hi)
                    u_next = df_add_f32(DF32(hi=uh, lo=ul), e)
                    return u_next.hi, u_next.lo, err, it + 1

                err_dt = (jnp.float64 if jax.config.jax_enable_x64
                          else jnp.float32)
                init = (jnp.zeros_like(bh), jnp.zeros_like(bh),
                        jnp.asarray(jnp.inf, dtype=err_dt),
                        jnp.asarray(0, dtype=jnp.int32))
                uh, ul, _, it = lax.while_loop(cond, body, init)
                final_err = lax.psum(
                    df_rss(residual(DF32(hi=uh, lo=ul))), AXIS)
                stats = jnp.stack([final_err,
                                   it.astype(err_dt)])
                return uh, ul, stats

            self._solve_device = jax.jit(jax.shard_map(
                solve_fn, mesh=self.mesh,
                in_specs=(spec_coeffs, P(), spec_field, spec_field,
                          P(), P()),
                out_specs=(spec_field, spec_field, P())))
        else:
            self._refine = None
            self._solve_device = None

    def pad_field(self, f2: jnp.ndarray) -> jnp.ndarray:
        """(side, side) -> sharded (n_pad, side)."""
        out = jnp.zeros((self.n_pad, self.side), dtype=self.dtype)
        out = out.at[:self.side].set(f2.astype(self.dtype))
        return jax.device_put(
            out, jax.sharding.NamedSharding(self.mesh, P(AXIS, None)))

    def unpad(self, f2: jnp.ndarray) -> jnp.ndarray:
        # Replicate before slicing: a non-slab-aligned slice of a sharded
        # array would otherwise need an ambiguous-sharding gather.
        full = jax.device_put(
            f2, jax.sharding.NamedSharding(self.mesh, P()))
        return full[:self.side]

    def vcycle(self, u_pad, b_pad):
        return self._vcycle(self.coeffs, self.sub_hier, u_pad, b_pad)

    def rss(self, u_pad, b_pad) -> float:
        return float(self._rss(self.coeffs[0], u_pad, b_pad))

    def solve(self, b2, tolerance=1e-7, compute_error_every_n_iters=5,
              n_iters=100) -> SolveResult:
        b_pad = self.pad_field(b2)
        u = jnp.zeros_like(b_pad)
        every = compute_error_every_n_iters
        it, error = 0, 100.0
        history = []
        while it < n_iters and error > tolerance:
            k = (min(every - (it % every), n_iters - it) if every
                 else n_iters - it)
            for _ in range(k):
                u = self.vcycle(u, b_pad)
            it += k
            if every and it % every == 0:
                error = self.rss(u, b_pad)
                history.append((it, error))
        return SolveResult(u=self.unpad(u), iterations=it, error=error,
                           converged=error <= tolerance, history=history)

    def solve_pcg(self, b2, tolerance: float = 1e-5,
                  n_iters: int = 100) -> SolveResult:
        """Distributed device-resident AMG-preconditioned CG: one
        dispatch, convergence control on device, inner products psum'd
        across the row shards (see pcg_fn above). Native-precision (the
        solver dtype): for reference-grade 1e-9 rss use the df32 defect
        correction (``solve_ir``/``solve_ir_fused``) — PCG here plays the
        same f32-native role as krylov.solve_pcg_device on one chip."""
        b_pad = self.pad_field(b2)
        u, stats = self._pcg_device(
            self.coeffs, self.sub_hier, b_pad,
            jnp.asarray(tolerance, dtype=self.dtype),
            jnp.asarray(n_iters, dtype=jnp.int32))
        err_v, it_v = np.asarray(stats)
        error, it = float(err_v), int(it_v)
        return SolveResult(u=self.unpad(u), iterations=it, error=error,
                           converged=error <= tolerance,
                           history=[(it, error)])

    def _split_b(self, b2):
        b = jnp.asarray(b2)
        if b.dtype == jnp.float64:
            from amg_jax.ops.doublefloat import split_f64

            bh_full, bl_full = split_f64(b)
        else:
            bh_full = b.astype(jnp.float32)
            bl_full = jnp.zeros_like(bh_full)
        return self.pad_field(bh_full), self.pad_field(bl_full)

    def solve_ir_device(self, b2, tolerance=1e-9, n_refine: int = 40):
        """One-dispatch device-resident mixed-precision solve: the whole
        defect-correction loop (df32 residual + psum'd rss + sharded
        V-cycles) runs inside a single jitted shard_map program with a
        lax.while_loop — no host synchronization per refinement step.
        Returns ((u_hi, u_lo) padded shards, stats=[final_rss, n_steps])."""
        if self._solve_device is None:
            raise NotImplementedError(
                "solve_ir_device requires a constant-stencil fine level")
        bh, bl = self._split_b(b2)
        err_dt = (jnp.float64 if jax.config.jax_enable_x64
                  else jnp.float32)
        return self._solve_device(self.coeffs, self.sub_hier, bh, bl,
                                  jnp.asarray(tolerance, dtype=err_dt),
                                  jnp.asarray(n_refine, dtype=jnp.int32))

    def solve_ir_fused(self, b2, tolerance=1e-9,
                       n_refine: int = 40) -> SolveResult:
        """solve_ir_device + one packed stats fetch (the distributed
        analog of StructuredSolver.solve_ir_fused)."""
        uh, ul, stats = self.solve_ir_device(b2, tolerance, n_refine)
        err_v, it_v = np.asarray(stats)
        error = float(err_v)
        iters = int(it_v) * self.cycles_per_refine
        u_hi = self.unpad(uh)
        u_lo = self.unpad(ul)
        if jax.config.jax_enable_x64:
            u = u_hi.astype(jnp.float64) + u_lo.astype(jnp.float64)
        else:
            u = u_hi
        return SolveResult(u=u, iterations=iters, error=error,
                           converged=error <= tolerance,
                           history=[(iters, error)])

    def solve_ir(self, b2, tolerance=1e-9, n_refine: int = 40
                 ) -> SolveResult:
        """Mixed-precision distributed solve: df32 defect correction around
        sharded f32 V-cycles (the distributed analog of
        StructuredSolver.solve_ir; reference tolerance contract
        testlib.cpp:158,204-206). ``b2`` may be f64 (split exactly into
        hi+lo) or f32."""
        if self._refine is None:
            raise NotImplementedError(
                "solve_ir requires a constant-stencil fine level; use "
                "solve() or the ELL distributed path for variable "
                "coefficients")
        bh, bl = self._split_b(b2)
        uh = jnp.zeros_like(bh)
        ul = jnp.zeros_like(bh)
        history = []
        it = 0
        error = float("inf")
        for _ in range(n_refine):
            uh2, ul2, err = self._refine(self.coeffs, self.sub_hier,
                                         uh, ul, bh, bl)
            error = float(err)
            history.append((it, error))
            if error <= tolerance:
                break
            uh, ul = uh2, ul2
            it += self.cycles_per_refine
        u_hi = self.unpad(uh)
        u_lo = self.unpad(ul)
        if jax.config.jax_enable_x64:
            u = u_hi.astype(jnp.float64) + u_lo.astype(jnp.float64)
        else:
            u = u_hi
        return SolveResult(u=u, iterations=it, error=error,
                           converged=error <= tolerance, history=history)
