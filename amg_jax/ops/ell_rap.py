"""Device-side Galerkin RAP for ELL operators (general/unstructured path).

The reference computes ``A_H = R (A P)`` with two host Eigen SpGEMMs
(multigrid.hpp:219-223); the structured path already has a closed-form
on-device RAP (ops/rap.py). This module supplies the ELL equivalent,
exploiting the reference transfer structure (interpolator.hpp:98-142):
P[2b + d, b] = w_d with w = (1/2, 1, 1/2) and R = P^T, which collapses the
triple product to a closed form over fine entries:

    A_H[a, b] = sum_{d1, d2 in {0,1,2}} w_{d1} w_{d2} A[2a + d1, 2b + d2]

Design: SpGEMM's irregular output sparsity fights XLA's static shapes,
so the product is split into a **symbolic phase** (host, once per pattern:
maps every contribution of every fine ELL slot to a static output slot) and
a **numeric phase** (jitted gather + scatter-add with entirely static
shapes). Hierarchies rebuild on device for new operator VALUES — e.g.
coefficient updates in a time-stepping loop — with zero host SpGEMM
round-trips (BASELINE config 4); only a pattern change re-runs the cheap
symbolic pass.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from amg_jax.sparse.ell import ELL

_W = (0.5, 1.0, 0.5)


def _expand_cols(cols: np.ndarray, vals_mask: np.ndarray, n_H: int):
    """Symbolic column expansion: each fine slot column c contributes to
    coarse columns b with c = 2b + d2 — two (c even: d2 in {0,2}) or one
    (c odd: d2 = 1) targets. Returns (b, w, ok) arrays of shape
    cols.shape + (2,)."""
    c = cols.astype(np.int64)
    even = c % 2 == 0
    b = np.stack([np.where(even, c // 2, (c - 1) // 2),
                  np.where(even, c // 2 - 1, -1)], axis=-1)
    w = np.stack([np.where(even, 0.5, 1.0),
                  np.where(even, 0.5, 0.0)], axis=-1)
    ok = (b >= 0) & (b < n_H) & (w != 0.0) & vals_mask[..., None]
    return b, w, ok


@partial(jax.tree_util.register_dataclass,
         data_fields=["assign", "out_cols", "weights"],
         meta_fields=["n_h", "n_H", "K", "K_out"])
@dataclasses.dataclass(frozen=True)
class EllRapPlan:
    """Precomputed symbolic structure of one Galerkin RAP level.

    assign:   (n_H, 6K) int32 — output slot for each expanded contribution
              (K_out = dropped/padding).
    out_cols: (n_H, K_out) int32 — coarse ELL column pattern.
    weights:  (n_H, 6K) — w_{d1} * w_{d2} per contribution (0 when dropped).
    """

    assign: jnp.ndarray
    out_cols: jnp.ndarray
    weights: jnp.ndarray
    n_h: int
    n_H: int
    K: int
    K_out: int

    @staticmethod
    def build(A_cols: np.ndarray, pad_mask: np.ndarray, n_h: int,
              n_H: int, dtype=np.float64) -> "EllRapPlan":
        """Symbolic phase (host, once per sparsity pattern).

        A_cols: (n_h, K) fine ELL column indices; pad_mask True on real
        (non-padding) slots."""
        K = A_cols.shape[1]
        b2, w2, ok2 = _expand_cols(A_cols, pad_mask, n_H)  # (n_h, K, 2)
        a = np.arange(n_H)
        rows3 = np.stack([2 * a, 2 * a + 1, 2 * a + 2], axis=1)  # (n_H, 3)
        assert rows3.max() < n_h
        # gathered contributions per coarse row: (n_H, 3, K, 2)
        gb = b2[rows3]
        gw = w2[rows3] * np.asarray(_W)[None, :, None, None]
        gok = ok2[rows3]
        gb = gb.reshape(n_H, 6 * K)
        gw = np.where(gok, gw, 0.0).reshape(n_H, 6 * K)
        gok = gok.reshape(n_H, 6 * K)
        # per-row output slot assignment (vectorized): sort contributions by
        # column, number the distinct-column runs, map back to slot order
        BIG = n_H + 1
        key = np.where(gok, gb, BIG)
        order = np.argsort(key, axis=1, kind="stable")
        sc = np.take_along_axis(key, order, axis=1)
        new_run = np.ones_like(sc, dtype=bool)
        new_run[:, 1:] = sc[:, 1:] != sc[:, :-1]
        new_run &= sc < BIG
        slot_sorted = np.cumsum(new_run, axis=1) - 1  # -1 before first run
        n_runs = new_run.sum(axis=1)
        K_out = max(int(n_runs.max()) if n_H else 0, 1)
        assign = np.full((n_H, 6 * K), K_out, dtype=np.int64)
        rr = np.broadcast_to(np.arange(n_H)[:, None], order.shape)
        valid_sorted = (sc < BIG) & (slot_sorted >= 0)
        assign[rr[valid_sorted], order[valid_sorted]] = \
            slot_sorted[valid_sorted]
        out_cols = np.tile(np.minimum(np.arange(n_H), max(n_H - 1, 0)
                                      )[:, None], (1, K_out))
        starts = new_run & (slot_sorted >= 0)
        out_cols[rr[starts], slot_sorted[starts]] = sc[starts]
        return EllRapPlan(assign=jnp.asarray(assign, dtype=jnp.int32),
                          out_cols=jnp.asarray(out_cols, dtype=jnp.int32),
                          weights=jnp.asarray(gw, dtype=dtype),
                          n_h=n_h, n_H=n_H, K=K, K_out=K_out)

    def apply(self, A_data: jnp.ndarray) -> ELL:
        """Numeric phase (jittable): fine ELL values -> coarse ELL.

        A_data: (n_h, K) fine values in the pattern the plan was built for.
        """
        n_H, K, K_out = self.n_H, self.K, self.K_out
        a = jnp.arange(n_H)
        rows3 = jnp.stack([2 * a, 2 * a + 1, 2 * a + 2], axis=1)
        gv = A_data[rows3].reshape(n_H, 3 * K)        # (n_H, 3K)
        gv = jnp.repeat(gv, 2, axis=1) * self.weights  # (n_H, 6K)
        out = jnp.zeros((n_H, K_out + 1), dtype=A_data.dtype)
        rows = jnp.broadcast_to(a[:, None], self.assign.shape)
        out = out.at[rows, self.assign].add(gv)
        return ELL(data=out[:, :K_out], cols=self.out_cols,
                   shape=(n_H, n_H))


def build_rap_plans(A: ELL, n_levels: int):
    """Symbolic phase for a whole hierarchy: plans for levels 1..n_levels-1.

    Runs the numeric phase level by level on host-visible patterns (the
    coarse pattern feeds the next plan); returns (plans, level_mats) where
    level_mats[0] is A itself."""
    plans = []
    mats = [A]
    for _ in range(n_levels - 1):
        cur = mats[-1]
        n_h = cur.n_rows
        n_H = (n_h + 1) // 2 - 1  # multigrid.hpp:127-130
        cols_np = np.asarray(cur.cols)
        mask_np = np.asarray(cur.data) != 0
        plan = EllRapPlan.build(cols_np, mask_np, n_h, n_H,
                                dtype=np.asarray(cur.data[:1, :1]).dtype)
        plans.append(plan)
        mats.append(plan.apply(cur.data))
    return plans, mats


@jax.jit
def apply_rap_chain(plans: tuple, A_data: jnp.ndarray):
    """Jitted hierarchy value rebuild: new fine values -> all coarse level
    values, entirely on device (the SpGEMM-free analog of
    multigrid.hpp:211-223 for repeated setups)."""
    datas = [A_data]
    for plan in plans:
        datas.append(plan.apply(datas[-1]).data)
    return tuple(datas)
