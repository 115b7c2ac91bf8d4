"""Distributed unstructured (ELL) multigrid: row-partitioned V-cycles for
arbitrary banded hierarchies — including the reference's flat 1-D
interpolation pipeline (interpolator.hpp:98-142) at scale.

Complements parallel/structured_dist.py (which requires 9-point grid
levels): here every level operator is a general ELL matrix whose rows are
partitioned into equal per-device blocks. The key mechanism is the
*windowed halo*: for banded matrices under contiguous row partitioning
(which the reference's lexicographic dof order produces, grid.hpp:88-98),
all column references of a device's rows fall inside
``[block_start - W, block_end + W)`` for a small host-computed W. Each op
then needs only one ppermute exchange of W-wide boundary slices — the
NCCL p2p pattern named in SURVEY.md §2, which XLA emits on a GPU mesh.

Column indices are rewritten at setup to *window coordinates*
(col - owner_block_start + W), so the device-local gather is
``x_ext[cols_local]`` with ``x_ext = [left_halo | x_loc | right_halo]`` —
static shapes, no runtime index arithmetic.

Levels stay sharded while their window fits the block (W <= B and B >= 2);
deeper levels are agglomerated: the coarse rhs is all_gather-ed and the
remaining sub-hierarchy runs replicated on every device (reusing the
single-device machinery from amg_jax/multigrid.py), with the dense-LU
coarsest solve (multigrid.hpp:240-243).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P

from amg_jax.multigrid import SolveResult, build_hierarchy, vcycle
from amg_jax.ops.smoothers import MulticolorGaussSeidel
from amg_jax.ops.transfer import LinearInterpolator

AXIS = "x"


# ---------------------------------------------------------------------------
# Host setup: padded/windowed ELL shards


def _pad_rows_csr(M, rows_pad: int, cols_pad: int):
    """Pad a scipy CSR to rows_pad rows acting on the padded column space
    [0, cols_pad): identity rows on the padding when the operator is
    square (so padded vector entries stay exactly zero through smoothing,
    matvec and rss), zero rows otherwise."""
    import scipy.sparse as sp

    M = M.tocsr()
    n_rows, n_cols = M.shape
    square = n_rows == n_cols
    M = sp.csr_matrix((M.data, M.indices, M.indptr),
                      shape=(n_rows, cols_pad))
    if square:
        eye_rows = np.arange(n_rows, rows_pad)
        pad = sp.coo_matrix(
            (np.ones(len(eye_rows)), (eye_rows - n_rows, eye_rows)),
            shape=(rows_pad - n_rows, cols_pad))
        Mp = sp.vstack([M, pad]).tocsr()
    else:
        pad = sp.csr_matrix((rows_pad - n_rows, cols_pad))
        Mp = sp.vstack([M, pad]).tocsr()
    Mp.sort_indices()
    return Mp


@dataclasses.dataclass(frozen=True)
class ShardedOp:
    """A row-partitioned ELL operator in window coordinates.

    data/cols: (D*B_row, K) arrays (sharded on axis 0 at dispatch).
    B_row: rows per device; B_x: per-device block of the input vector x;
    W: halo width each side of the local x block.
    """

    data: jnp.ndarray
    cols: jnp.ndarray
    B_row: int
    B_x: int
    W: int

    @staticmethod
    def build(M, D: int, B_row: int, B_x: int, dtype,
              as_numpy: bool = False) -> "ShardedOp":
        """M: scipy CSR (n_rows x n_cols). Rows padded to D*B_row with
        identity rows when square (n_rows == n_cols) or zero rows
        otherwise; columns rewritten to window coordinates."""
        Mp = _pad_rows_csr(M, D * B_row, D * B_x)
        rows_pad, cols_pad = Mp.shape
        deg = np.diff(Mp.indptr)
        K = max(int(deg.max()), 1)
        data = np.zeros((rows_pad, K), dtype=np.float64)
        rows_of = np.repeat(np.arange(rows_pad), deg)
        pos = np.arange(Mp.nnz) - np.repeat(Mp.indptr[:-1], deg)
        data[rows_of, pos] = Mp.data
        colsg = np.zeros((rows_pad, K), dtype=np.int64)
        colsg[rows_of, pos] = Mp.indices
        # padding slots: owner's own block start (maps inside the window)
        owner = (np.arange(rows_pad) // B_row)[:, None]
        pad_slot = data == 0
        colsg = np.where(pad_slot, owner * B_x, colsg)
        # window width: max distance of any referenced column outside the
        # owner's [0, B_x) block
        rel = colsg - owner * B_x
        W = int(max(1, np.max(np.maximum(-rel, rel - (B_x - 1)))))
        cols_local = rel + W
        assert cols_local.min() >= 0
        assert cols_local.max() < B_x + 2 * W
        if as_numpy:  # host f64 form (df32 splitting keeps full precision)
            return ShardedOp(data=data, cols=cols_local.astype(np.int32),
                             B_row=B_row, B_x=B_x, W=W)
        return ShardedOp(data=jnp.asarray(data, dtype=dtype),
                         cols=jnp.asarray(cols_local, dtype=jnp.int32),
                         B_row=B_row, B_x=B_x, W=W)


jax.tree_util.register_dataclass(
    ShardedOp, data_fields=["data", "cols"],
    meta_fields=["B_row", "B_x", "W"])


def _exchange_w(x_loc, W: int, D: int):
    """Window halo: left = last W of left neighbor, right = first W of
    right neighbor (zeros at the edges)."""
    dtype = x_loc.dtype
    if D == 1 or W == 0:
        z = jnp.zeros((W,), dtype=dtype)
        return z, z
    left = lax.ppermute(x_loc[-W:], AXIS, [(i, i + 1) for i in range(D - 1)])
    right = lax.ppermute(x_loc[:W], AXIS, [(i + 1, i) for i in range(D - 1)])
    return left, right


def _exchange_strips_1d(u_loc, b_loc, H: int, D: int):
    """One ghost-strip exchange for a whole multicolor sweep: H-wide u and
    b boundary strips ride the SAME ppermute pair (zeros at ring edges).
    The banded-window analog of structured_dist._exchange_strips."""
    z = jnp.zeros((H,), dtype=u_loc.dtype)
    if D == 1 or H == 0:
        return (jnp.concatenate([z, u_loc, z]),
                jnp.concatenate([z, b_loc, z]))
    down = jnp.concatenate([u_loc[-H:], b_loc[-H:]])
    up = jnp.concatenate([u_loc[:H], b_loc[:H]])
    left = lax.ppermute(down, AXIS, [(i, i + 1) for i in range(D - 1)])
    right = lax.ppermute(up, AXIS, [(i + 1, i) for i in range(D - 1)])
    u_ext = jnp.concatenate([left[:H], u_loc, right[:H]])
    b_ext = jnp.concatenate([left[H:], b_loc, right[H:]])
    return u_ext, b_ext


def build_ext_panels(M, colors_pad, diag_pad, D: int, B: int, H: int):
    """Per-device extended row panels for ghost-strip multicolor sweeps.

    Each device updates rows [d*B - H, d*B + B + H) of the padded square
    operator during the sweep (temporal blocking: one color step
    invalidates W extended rows per side, so H = n_steps*W leaves the
    whole [d*B, d*B + B) block exact after all steps — the banded analog
    of the structured ghost-strip sweep, structured_dist.py:150-194).
    Columns are rewritten to extended-x coordinates (g - (d*B - H)),
    clamped into [0, B + 2H): out-of-window references occur only on
    rows whose updates the validity induction discards.

    Returns numpy (dataE, colsE, masksE, diagE) with row layout
    (D*(B+2H), ...): device d's panel occupies rows [d*E, (d+1)*E).
    """
    rows_pad = D * B
    Mp = _pad_rows_csr(M, rows_pad, rows_pad)
    deg = np.diff(Mp.indptr)
    K = max(int(deg.max()), 1)
    data_g = np.zeros((rows_pad, K))
    cols_g = np.zeros((rows_pad, K), dtype=np.int64)
    rows_of = np.repeat(np.arange(rows_pad), deg)
    pos = np.arange(Mp.nnz) - np.repeat(Mp.indptr[:-1], deg)
    data_g[rows_of, pos] = Mp.data
    cols_g[rows_of, pos] = Mp.indices
    # empty slots reference the row itself (always inside the window)
    cols_g = np.where(data_g == 0, np.arange(rows_pad)[:, None], cols_g)
    E = B + 2 * H
    C = int(colors_pad.max()) + 1
    dataE = np.zeros((D * E, K))
    colsE = np.zeros((D * E, K), dtype=np.int64)
    diagE = np.ones(D * E)
    colorsE = np.full(D * E, -1, dtype=np.int64)  # -1: no color fires
    for d in range(D):
        lo, hi = d * B - H, d * B + B + H
        src_lo, src_hi = max(lo, 0), min(hi, rows_pad)
        dst = d * E + (src_lo - lo)
        m = src_hi - src_lo
        dataE[dst:dst + m] = data_g[src_lo:src_hi]
        colsE[dst:dst + m] = np.clip(cols_g[src_lo:src_hi] - lo, 0, E - 1)
        diagE[dst:dst + m] = diag_pad[src_lo:src_hi]
        colorsE[dst:dst + m] = colors_pad[src_lo:src_hi]
    masksE = np.stack([(colorsE == c) for c in range(C)]).astype(np.float64)
    return dataE, colsE, masksE, diagE


def _matvec_local(op: ShardedOp, data_loc, cols_loc, x_loc, D: int):
    left, right = _exchange_w(x_loc, op.W, D)
    x_ext = jnp.concatenate([left, x_loc, right])
    return jnp.sum(data_loc * x_ext[cols_loc], axis=1)


# ---------------------------------------------------------------------------
# Hierarchy


class EllDistSolver:
    """Row-partitioned V-cycle solver for a general (banded) hierarchy.

    Defaults to the reference pipeline: flat 1-D LinearInterpolator
    transfer + Galerkin RAP (multigrid.hpp:211-243) with multicolor GS
    smoothing. Correctness contract: identical iterate sequence to the
    single-device multicolor solver (tests/test_ell_dist.py).

    halo: 'step' exchanges the W-wide window once per color step (2C
    ppermute pairs per symmetric sweep); 'strips' exchanges ONE
    H = n_steps*W ghost strip per sweep and recomputes neighbor boundary
    rows locally (extended panels, build_ext_panels) — identical iterates
    (tests/test_ell_dist.py::test_ell_halo_strips_matches_step). 'strips'
    trades ~(B+2H)/B extra compute for 2C-x fewer collectives: the right
    choice when inter-host/ICI latency dominates; on the virtual CPU mesh
    (where ppermute is a memcpy) 'step' measures faster
    (benchmarks/scaling.py ell_halo_mode), hence the default.
    """

    def __init__(self, A, b, n_levels: int, n_devices: int | None = None,
                 dtype=jnp.float64, interpolator=None, omega: float = 1.0,
                 symmetric: bool = True, min_rows: int = 2,
                 halo: str = "step", config=None,
                 cycles_per_refine: int | None = None):
        import scipy.sparse as sp
        from amg_jax.sparse.ell import ELL
        from amg_jax.utils.coloring import greedy_coloring

        # config.MeshConfig centralizes the distribution knobs (the ELL
        # path accepts only its own halo modes; a structured-only mode in
        # the config falls back to this path's default)
        if config is not None:
            if n_devices is None:
                n_devices = config.n_devices
            min_rows = getattr(config, "min_rows_per_device", min_rows)
            cfg_halo = getattr(config, "halo", halo)
            if cfg_halo in ("strips", "step"):
                halo = cfg_halo
            if cycles_per_refine is None:
                cycles_per_refine = getattr(config, "cycles_per_refine",
                                            None)
        if cycles_per_refine is None:
            cycles_per_refine = 2
        self.cycles_per_refine = cycles_per_refine
        if n_devices is None:
            n_devices = len(jax.devices())
        if halo not in ("strips", "step"):
            raise ValueError(f"unknown halo mode {halo!r}; "
                             "expected 'strips' or 'step'")
        D = n_devices
        self.D = D
        self.dtype = dtype
        self.omega = omega
        self.symmetric = symmetric
        self.halo = halo
        A_sp = A.to_scipy() if isinstance(A, ELL) else A.tocsr()
        interp = interpolator or LinearInterpolator(n_levels)

        # host Galerkin chain (reference ctor structure)
        mats = [A_sp]
        Ps, Rs = [], []
        for _ in range(n_levels - 1):
            n_h = mats[-1].shape[0]
            n_H = interp.coarse_size(n_h)
            Pm, Rm = interp.make_operators_scipy(n_h, n_H)
            Ps.append(Pm.tocsr())
            Rs.append(Rm.tocsr())
            mats.append((Rm @ (mats[-1] @ Pm)).tocsr())

        # choose sharded prefix: B_l = ceil(n_l/D) even; stay sharded while
        # window fits the block
        sizes = [M.shape[0] for M in mats]
        Bs = [max(2, -(-s // D)) for s in sizes]
        Bs = [b + (b % 2) for b in Bs]
        ops = []
        Ls = 0
        for l in range(n_levels - 1):
            A_op = ShardedOp.build(mats[l], D, Bs[l], Bs[l], dtype)
            R_op = ShardedOp.build(Rs[l], D, Bs[l + 1], Bs[l], dtype)
            P_op = ShardedOp.build(Ps[l], D, Bs[l], Bs[l + 1], dtype)
            ok = (A_op.W <= Bs[l] and R_op.W <= Bs[l]
                  and P_op.W <= Bs[l + 1] and Bs[l] >= min_rows
                  and sizes[l] >= D * min_rows)
            if not ok:
                break
            ops.append((A_op, R_op, P_op))
            Ls = l + 1
        if Ls == 0:
            raise ValueError(
                f"problem too small to shard over {D} devices")
        self.Ls = Ls
        self.sizes = sizes
        self.Bs = Bs

        # per-level color masks + diag (padded, sharded layout)
        def level_aux(l):
            n = sizes[l]
            rows_pad = D * Bs[l]
            ell = ELL.from_scipy(mats[l], dtype=dtype)
            colors = greedy_coloring(np.asarray(ell.cols),
                                     np.asarray(ell.data), n)
            C = int(colors.max()) + 1
            colors_pad = np.zeros(rows_pad, dtype=np.int64)
            colors_pad[:n] = colors
            colors_pad[n:] = 0
            masks = np.stack([(colors_pad == c) for c in range(C)]
                             ).astype(np.float64)
            # padded rows: allow color-0 updates (diag 1, b 0 -> stays 0)
            dd = np.zeros(rows_pad)
            dd[:n] = mats[l].diagonal()
            dd[n:] = 1.0
            return masks, dd, colors_pad

        levels = []
        ext_meta, ext_arrs = [], []
        for l in range(Ls):
            A_op, R_op, P_op = ops[l]
            masks_np, diag_np, colors_pad = level_aux(l)
            levels.append(dict(A=A_op, R=R_op, P=P_op,
                               masks=jnp.asarray(masks_np, dtype=dtype),
                               diag=jnp.asarray(diag_np, dtype=dtype)))
            # ghost strips: ONE exchange per sweep instead of one per color
            # step (2C ppermute pairs -> 1). Eligible while the strip fits
            # one neighbor slab (H <= B; extended compute <= 3x local).
            #
            # Strip width uses the TRUE per-row reach beta = max|col - row|
            # (host numpy over the level matrix), NOT ShardedOp.W: W only
            # measures how far referenced columns overflow the owner's
            # block, but the temporal-blocking invalid front advances by
            # the full coupling distance per color step — a row coupling
            # across beta > W *inside* a block would exceed an H built
            # from W and silently corrupt rows in the supposedly-exact
            # region (tests/test_ell_dist.py long-range case).
            # W keeps serving the per-step window path, which only needs
            # the block-overflow bound.
            C = masks_np.shape[0]
            n_steps = (2 * C if symmetric else C)
            Ml_coo = mats[l].tocoo()
            beta = (int(np.abs(Ml_coo.col - Ml_coo.row).max())
                    if Ml_coo.nnz else 0)
            beta = max(beta, 1)
            H = n_steps * beta
            if halo == "strips" and 0 < H <= Bs[l]:
                dE, cE, mE, gE = build_ext_panels(
                    mats[l], colors_pad, diag_np, D, Bs[l], H)
                ext_meta.append(H)
                ext_arrs.append((jnp.asarray(dE, dtype=dtype),
                                 jnp.asarray(cE, dtype=jnp.int32),
                                 jnp.asarray(mE, dtype=dtype),
                                 jnp.asarray(gE, dtype=dtype)))
            else:
                ext_meta.append(None)
                ext_arrs.append(())
        self.levels = levels
        self._ext_meta = ext_meta
        self._ext_arrs = tuple(ext_arrs)

        # boundary prolongation uses global coarse indices into the
        # replicated coarse vector (padded with one zero slot for pads)
        Pb = Ps[Ls - 1].tocsr() if Ls - 1 < len(Ps) else None
        self._setup_boundary(Pb, mats, Rs, Ls, D, dtype)

        # replicated sub-hierarchy (levels Ls..n_levels-1) reusing the
        # single-device machinery
        self.sub_smoother = MulticolorGaussSeidel(omega=omega,
                                                 symmetric=symmetric)
        sub_interp = _FixedChain(Ps[Ls:], Rs[Ls:], sizes[Ls:])
        self.sub_hier = build_hierarchy(mats[Ls], n_levels - Ls, sub_interp,
                                        self.sub_smoother, dtype=dtype)

        # df32 split of the fine operator (host, from the f64 values) for
        # the mixed-precision distributed solve
        A0_np = ShardedOp.build(mats[0], D, Bs[0], Bs[0], dtype,
                                as_numpy=True)
        a_hi = np.asarray(A0_np.data, dtype=np.float32)
        a_lo = np.asarray(A0_np.data - a_hi.astype(np.float64),
                          dtype=np.float32)
        self._A0_hi = jnp.asarray(a_hi)
        self._A0_lo = jnp.asarray(a_lo)
        self._b64 = np.asarray(b, dtype=np.float64)

        self.b = jnp.asarray(np.asarray(b), dtype=dtype)
        self._build_program()

    def _setup_boundary(self, Pb, mats, Rs, Ls, D, dtype):
        """Prolongation from the (replicated) level Ls onto the sharded
        level Ls-1: ELL panels with global coarse column indices."""
        import scipy.sparse as sp

        n_f = self.sizes[Ls - 1]
        rows_pad = D * self.Bs[Ls - 1]
        Pp = sp.vstack([Pb, sp.csr_matrix((rows_pad - n_f, Pb.shape[1]))]
                       ).tocsr()
        Pp.sort_indices()
        deg = np.diff(Pp.indptr)
        K = max(int(deg.max()), 1)
        data = np.zeros((rows_pad, K))
        cols = np.zeros((rows_pad, K), dtype=np.int64)
        rows_of = np.repeat(np.arange(rows_pad), deg)
        pos = np.arange(Pp.nnz) - np.repeat(Pp.indptr[:-1], deg)
        data[rows_of, pos] = Pp.data
        cols[rows_of, pos] = Pp.indices
        self._Pb_data = jnp.asarray(data, dtype=dtype)
        self._Pb_cols = jnp.asarray(cols, dtype=jnp.int32)

    def _build_program(self):
        D = self.D
        Ls = self.Ls
        mesh = jax.make_mesh((D,), (AXIS,), devices=jax.devices()[:D])
        self.mesh = mesh
        omega = self.omega
        symmetric = self.symmetric
        sub_hier = self.sub_hier
        cpr = self.cycles_per_refine
        sub_smoother = self.sub_smoother
        levels = self.levels
        sizes = self.sizes
        Bs = self.Bs
        n_sub = sizes[Ls]

        ext_meta = self._ext_meta

        def mc_sweep(l, data_loc, cols_loc, masks_loc, diag_loc, u_loc,
                     b_loc, ext):
            op = levels[l]["A"]
            C = masks_loc.shape[0]
            order = list(range(C))
            if symmetric:
                order = order + order[::-1]
            if ext:
                # ghost-strip sweep: one H-wide exchange, then every color
                # step runs locally on the extended rows (temporal
                # blocking; H = n_steps*W keeps the block exact)
                dataE, colsE, masksE, diagE = ext
                H = ext_meta[l]
                u_ext, b_ext = _exchange_strips_1d(u_loc, b_loc, H, D)
                for c in order:
                    r = b_ext - jnp.sum(dataE * u_ext[colsE], axis=1)
                    u_ext = u_ext + (omega * masksE[c]) * (r / diagE)
                return u_ext[H:H + op.B_x]
            for c in order:
                r = b_loc - _matvec_local(op, data_loc, cols_loc, u_loc, D)
                u_loc = u_loc + (omega * masks_loc[c]) * (r / diag_loc)
            return u_loc

        def vcycle_local(level_arrays, ext_arrays, Pb_data_loc, Pb_cols_loc,
                         u_loc, b_loc):
            us = [None] * Ls
            bs = [None] * Ls
            us[0], bs[0] = u_loc, b_loc
            for l in range(Ls):
                aA, cA, aR, cR, aP, cP, masks, diag = level_arrays[l]
                us[l] = mc_sweep(l, aA, cA, masks, diag, us[l], bs[l],
                                 ext_arrays[l])
                r = bs[l] - _matvec_local(levels[l]["A"], aA, cA, us[l], D)
                coarse = _matvec_local(levels[l]["R"], aR, cR, r, D)
                if l < Ls - 1:
                    bs[l + 1] = coarse
                    us[l + 1] = jnp.zeros_like(coarse)
                else:
                    full = lax.all_gather(coarse, AXIS, tiled=True)
                    b_repl = full[:n_sub]
            u_repl = vcycle(sub_hier, sub_smoother,
                            jnp.zeros_like(b_repl), b_repl)
            for l in range(Ls - 1, -1, -1):
                aA, cA, aR, cR, aP, cP, masks, diag = level_arrays[l]
                if l == Ls - 1:
                    u_pad = jnp.concatenate(
                        [u_repl, jnp.zeros((1,), dtype=u_repl.dtype)])
                    corr = jnp.sum(Pb_data_loc * u_pad[Pb_cols_loc], axis=1)
                else:
                    corr = _matvec_local(levels[l]["P"], aP, cP, us[l + 1],
                                         D)
                us[l] = us[l] + corr
                us[l] = mc_sweep(l, aA, cA, masks, diag, us[l], bs[l],
                                 ext_arrays[l])
            return us[0]

        def rss_local(a0, c0, u_loc, b_loc):
            r = b_loc - _matvec_local(levels[0]["A"], a0, c0, u_loc, D)
            return lax.psum(jnp.sum(r * r), AXIS)

        def df_refine_local(level_arrays, ext_arrays, Pb_data_loc,
                            Pb_cols_loc, a0_hi, a0_lo, uh, ul, bh, bl):
            """One df32 defect-correction step on the sharded fine level:
            double-float residual + rss (reference-grade accuracy from
            f32 arithmetic), then ``cycles_per_refine`` f32 V-cycles on the
            residual. The hi/lo halo windows ride one ppermute pair."""
            from amg_jax.ops.doublefloat import (DF32, df_add, df_add_f32,
                                                 df_mul, df_neg, df_rss)

            op = levels[0]["A"]
            W = op.W
            if D == 1 or W == 0:
                z = jnp.zeros((W,), dtype=uh.dtype)
                lh = rh = ll = rl = z
            else:
                down = jnp.concatenate([uh[-W:], ul[-W:]])
                up = jnp.concatenate([uh[:W], ul[:W]])
                left = lax.ppermute(down, AXIS,
                                    [(i, i + 1) for i in range(D - 1)])
                right = lax.ppermute(up, AXIS,
                                     [(i + 1, i) for i in range(D - 1)])
                lh, ll = left[:W], left[W:]
                rh, rl = right[:W], right[W:]
            xh = jnp.concatenate([lh, uh, rh])
            xl = jnp.concatenate([ll, ul, rl])
            cols = level_arrays[0][1]
            a_df = DF32(hi=a0_hi, lo=a0_lo)
            x_df = DF32(hi=xh[cols], lo=xl[cols])
            prod = df_mul(a_df, x_df)           # (rows, K) slotwise
            acc = DF32(hi=prod.hi[:, 0], lo=prod.lo[:, 0])
            for k in range(1, prod.hi.shape[1]):
                acc = df_add(acc, DF32(hi=prod.hi[:, k],
                                       lo=prod.lo[:, k]))
            r = df_add(DF32(hi=bh, lo=bl), df_neg(acc))
            err = lax.psum(df_rss(r), AXIS)
            e = jnp.zeros_like(uh)
            for _ in range(cpr):  # cycles_per_refine (MeshConfig knob)
                e = vcycle_local(level_arrays, ext_arrays, Pb_data_loc,
                                 Pb_cols_loc, e, r.hi)
            u_next = df_add_f32(DF32(hi=uh, lo=ul), e)
            return u_next.hi, u_next.lo, err

        def pcg_local(level_arrays, ext_arrays, Pb_data_loc, Pb_cols_loc,
                      b_loc, tol, n_iters):
            """Device-resident distributed PCG on the general (ELL)
            path: inner products and rss psum'd over the row shards,
            preconditioned by one shard_map V-cycle, the whole iteration
            one lax.while_loop — the ELL analog of
            DistStructuredSolver.solve_pcg. CG runs on
            the negated (SPD) system, krylov.py convention."""
            a0, c0 = level_arrays[0][0], level_arrays[0][1]

            def A_neg(x):
                return -_matvec_local(levels[0]["A"], a0, c0, x, D)

            def precond(r):
                return -vcycle_local(level_arrays, ext_arrays,
                                     Pb_data_loc, Pb_cols_loc,
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

        arrs = tuple(
            (levels[l]["A"].data, levels[l]["A"].cols,
             levels[l]["R"].data, levels[l]["R"].cols,
             levels[l]["P"].data, levels[l]["P"].cols,
             levels[l]["masks"], levels[l]["diag"])
            for l in range(Ls))
        spec_lvl = tuple(
            (P(AXIS, None), P(AXIS, None), P(AXIS, None), P(AXIS, None),
             P(AXIS, None), P(AXIS, None), P(None, AXIS), P(AXIS))
            for _ in range(Ls))
        spec_ext = tuple(
            (P(AXIS, None), P(AXIS, None), P(None, AXIS), P(AXIS))
            if self._ext_meta[l] is not None else ()
            for l in range(Ls))
        fld = P(AXIS)
        self._arrs = arrs
        self._vcycle = jax.jit(jax.shard_map(
            vcycle_local, mesh=mesh,
            in_specs=(spec_lvl, spec_ext, P(AXIS, None), P(AXIS, None),
                      fld, fld),
            out_specs=fld))
        self._rss = jax.jit(jax.shard_map(
            rss_local, mesh=mesh,
            in_specs=(P(AXIS, None), P(AXIS, None), fld, fld),
            out_specs=P()))
        self._refine = jax.jit(jax.shard_map(
            df_refine_local, mesh=mesh,
            in_specs=(spec_lvl, spec_ext, P(AXIS, None), P(AXIS, None),
                      P(AXIS, None), P(AXIS, None), fld, fld, fld, fld),
            out_specs=(fld, fld, P())))
        self._pcg = jax.jit(jax.shard_map(
            pcg_local, mesh=mesh,
            in_specs=(spec_lvl, spec_ext, P(AXIS, None), P(AXIS, None),
                      fld, P(), P()),
            out_specs=(fld, P())))

    # -- public API -------------------------------------------------------

    def pad_vec(self, v):
        n_pad = self.D * self.Bs[0]
        out = jnp.zeros(n_pad, dtype=self.dtype)
        out = out.at[:self.sizes[0]].set(jnp.asarray(v, dtype=self.dtype))
        return jax.device_put(
            out, jax.sharding.NamedSharding(self.mesh, P(AXIS)))

    def unpad_vec(self, v):
        full = jax.device_put(
            v, jax.sharding.NamedSharding(self.mesh, P()))
        return full[:self.sizes[0]]

    def vcycle_once(self, u_pad, b_pad):
        return self._vcycle(self._arrs, self._ext_arrs, self._Pb_data,
                            self._Pb_cols, u_pad, b_pad)

    def rss(self, u_pad, b_pad) -> float:
        a0, c0 = self._arrs[0][0], self._arrs[0][1]
        return float(self._rss(a0, c0, u_pad, b_pad))

    def solve_pcg(self, tolerance: float = 1e-9,
                  n_iters: int = 100) -> SolveResult:
        """Distributed device-resident AMG-preconditioned CG on the
        general (ELL) path: one dispatch, psum'd inner products, V-cycle
        preconditioner — see pcg_local. Native-precision (the solver
        dtype); wrap in solve_ir for df32-grade tolerances in f32."""
        import numpy as np

        b_pad = self.pad_vec(self.b)
        u, stats = self._pcg(self._arrs, self._ext_arrs, self._Pb_data,
                             self._Pb_cols, b_pad,
                             jnp.asarray(tolerance, dtype=self.dtype),
                             jnp.asarray(n_iters, dtype=jnp.int32))
        err_v, it_v = np.asarray(stats)
        error, it = float(err_v), int(it_v)
        return SolveResult(u=self.unpad_vec(u), iterations=it,
                           error=error, converged=error <= tolerance,
                           history=[(it, error)])

    def solve(self, tolerance=1e-9, compute_error_every_n_iters=5,
              n_iters=100) -> SolveResult:
        b_pad = self.pad_vec(self.b)
        u = jnp.zeros_like(b_pad)
        every = compute_error_every_n_iters
        it, error = 0, 100.0
        history = []
        while it < n_iters and error > tolerance:
            k = (min(every - (it % every), n_iters - it) if every
                 else n_iters - it)
            for _ in range(k):
                u = self.vcycle_once(u, b_pad)
            it += k
            if every and it % every == 0:
                error = self.rss(u, b_pad)
                history.append((it, error))
        return SolveResult(u=self.unpad_vec(u), iterations=it, error=error,
                           converged=error <= tolerance, history=history)

    def solve_ir(self, tolerance=1e-9, n_refine: int = 40) -> SolveResult:
        """Mixed-precision distributed solve for f32 hierarchies: df32
        residual/rss defect correction around the sharded f32 V-cycle —
        reaches the reference's 1e-9-grade rss (testlib.cpp:158) on
        hardware without f64 support. (f64 hierarchies just use solve().)
        """
        if self.dtype != jnp.float32:
            raise NotImplementedError(
                "solve_ir is the f32+df32 path; an f64 hierarchy reaches "
                "reference tolerances with solve() directly")
        n_pad = self.D * self.Bs[0]
        bh_full = np.zeros(n_pad, dtype=np.float32)
        bl_full = np.zeros(n_pad, dtype=np.float32)
        bh_full[:self.sizes[0]] = self._b64.astype(np.float32)
        bl_full[:self.sizes[0]] = (
            self._b64 - bh_full[:self.sizes[0]].astype(np.float64)
        ).astype(np.float32)
        shard = jax.sharding.NamedSharding(self.mesh, P(AXIS))
        bh = jax.device_put(jnp.asarray(bh_full), shard)
        bl = jax.device_put(jnp.asarray(bl_full), shard)
        uh = jnp.zeros_like(bh)
        ul = jnp.zeros_like(bh)
        history = []
        it = 0
        error = float("inf")
        for _ in range(n_refine):
            uh2, ul2, err = self._refine(self._arrs, self._ext_arrs,
                                         self._Pb_data, self._Pb_cols,
                                         self._A0_hi, self._A0_lo,
                                         uh, ul, bh, bl)
            error = float(err)
            history.append((it, error))
            if error <= tolerance:
                break
            uh, ul = uh2, ul2
            it += self.cycles_per_refine
        u_hi = self.unpad_vec(uh)
        u_lo = self.unpad_vec(ul)
        if jax.config.jax_enable_x64:
            u = u_hi.astype(jnp.float64) + u_lo.astype(jnp.float64)
        else:
            u = u_hi
        return SolveResult(u=u, iterations=it, error=error,
                           converged=error <= tolerance, history=history)


class _FixedChain:
    """Interpolator facade replaying a precomputed P/R chain (used to build
    the replicated sub-hierarchy without recomputing operators)."""

    def __init__(self, Ps, Rs, sizes):
        self._Ps = list(Ps)
        self._Rs = list(Rs)
        self._sizes = list(sizes)
        self._i = 0
        self.level_to_P = {}
        self.level_to_R = {}

    def coarse_size(self, n_h):
        return self._Ps[self._i].shape[1]

    def make_operators_scipy(self, n_h, n_H):
        Pm, Rm = self._Ps[self._i], self._Rs[self._i]
        self._i += 1
        return Pm, Rm

    def set_level_to_P(self, level, P):
        self.level_to_P[level] = P

    def set_level_to_R(self, level, R):
        self.level_to_R[level] = R
