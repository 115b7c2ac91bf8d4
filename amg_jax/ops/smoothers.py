"""Smoothers: weighted Jacobi, Gauss-Seidel (sequential-parity + multicolor), SOR.

A JAX redesign of the reference smoother layer (include/amg/smoother.hpp).
The reference mutates ``u`` in place through virtual ``smooth(A, u, b)``
(smoother.hpp:63-65); here every smoother is a pair of pure functions:

  * ``setup(A: ELL) -> state``   (host/trace time, once per level)
  * ``apply(state, u, b) -> u``  (jittable, one smoother iteration)

plus a standalone ``smooth`` driver reproducing the reference's stopping
semantics (``while iter < n_iters && error > tol`` with rss checks every
``compute_error_every_n_iters``; smoother.hpp:189-214).

Design notes:
  * The reference's sequential Gauss-Seidel sweep has a loop-carried
    dependency (each update reads entries written earlier in the sweep;
    smoother.hpp:129-174). Here a *sequential-parity* sweep is expressed as a
    dense triangular solve — mathematically identical to the lexicographic
    sweep — used for reference-matching on small/medium levels, and a
    *multicolor* sweep (independent updates within each color) as the
    production parallel path.
  * The reference's ``Jacobi`` (smoother.hpp:223-264) updates in place and is
    therefore actually a Gauss-Seidel recurrence with Jacobi's formula; we
    provide the textbook weighted Jacobi ``u += w D^-1 (b - A u)`` (the
    natural data-parallel smoother) and note the divergence. Reference-identical
    behavior is available via SOR(omega=1) in sequential mode.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from amg_jax.sparse.ell import ELL
from amg_jax.utils.metrics import rss
from amg_jax.utils.coloring import greedy_coloring


# ---------------------------------------------------------------------------
# Result / config containers


@dataclasses.dataclass
class SmootherResult:
    """Structured replacement for the reference's convergence prints
    (smoother.hpp:205-212)."""

    u: jnp.ndarray
    iterations: int
    error: float
    converged: bool
    history: list  # (iteration, rss) pairs at each check


class SmootherBase:
    """Hyperparameters mirror SmootherBase (smoother.hpp:25-37):
    tolerance 1e-9, compute_error_every_n_iters 100, n_iters 1.

    ``compute_error_every_n_iters == 0`` means "never check" (the reference's
    SPGS uses 0 this way, smoother.hpp:183-187; its Jacobi/SOR would divide
    by zero on 0 — a bug we do not replicate).
    """

    def __init__(self, tolerance=1e-9, compute_error_every_n_iters=100,
                 n_iters=1):
        self.tolerance = tolerance
        self.compute_error_every_n_iters = compute_error_every_n_iters
        self.n_iters = n_iters

    # subclasses implement setup/apply
    def setup(self, A: ELL) -> Any:
        raise NotImplementedError

    def apply(self, state, u, b):
        raise NotImplementedError

    def smooth(self, A: ELL, u, b, verbose=False) -> SmootherResult:
        """Standalone iterate-to-tolerance driver (smoother.hpp:189-214).

        One "iteration" is one call of ``apply`` (for symmetric GS that is a
        forward + backward sweep pair, matching the reference). Runs the
        check cadence on host around jitted sweep chunks.
        """
        state = self.setup(A)
        every = self.compute_error_every_n_iters
        n_iters = self.n_iters
        tol = self.tolerance

        @partial(jax.jit, static_argnums=(2,))
        def sweep_chunk(state, u_b, k):
            u, b_ = u_b
            u = jax.lax.fori_loop(
                0, k, lambda _, uu: self.apply(state, uu, b_), u)
            return u

        rss_j = jax.jit(lambda A_, u, b_: rss(A_, u, b_))

        it = 0
        error = 100.0  # reference sentinel (smoother.hpp:193)
        history = []
        while it < n_iters and error > tol:
            if every and every > 0:
                k = min(every - (it % every), n_iters - it)
            else:
                k = n_iters - it
            u = sweep_chunk(state, (u, b), k)
            it += k
            if every and it % every == 0:
                error = float(rss_j(A, u, b))
                history.append((it, error))
        converged = error <= tol
        if verbose and every:
            name = type(self).__name__
            word = "converged" if converged else "did not converge"
            print(f"{name} {word} after {it} iterations.")
        return SmootherResult(u=u, iterations=it, error=error,
                              converged=converged, history=history)


# ---------------------------------------------------------------------------
# Weighted Jacobi — the natural data-parallel smoother (SpMV + elementwise)


@partial(jax.tree_util.register_dataclass,
         data_fields=["A", "inv_diag"], meta_fields=["omega"])
@dataclasses.dataclass(frozen=True)
class JacobiState:
    A: ELL
    inv_diag: jnp.ndarray
    omega: float


class Jacobi(SmootherBase):
    """Textbook weighted Jacobi: ``u += omega * D^-1 (b - A u)``.

    Vectorized replacement for the reference Jacobi (smoother.hpp:223-264),
    which used O(n^2) random-access ``coeff`` lookups — the profiled
    bottleneck that motivated the sparse rewrite (README.md:86-88,
    callgrind artifact). One iteration = one sweep.
    """

    def __init__(self, *args, omega: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.omega = omega

    def setup(self, A: ELL) -> JacobiState:
        d = A.diag()
        # Zero diagonal => leave entry untouched (smoother.hpp:136 semantics).
        inv = jnp.where(d == 0, 0.0, 1.0 / jnp.where(d == 0, 1.0, d))
        return JacobiState(A=A, inv_diag=inv, omega=self.omega)

    def apply(self, state: JacobiState, u, b):
        r = b - state.A.matvec(u)
        return u + state.omega * state.inv_diag * r


# ---------------------------------------------------------------------------
# Sequential-parity Gauss-Seidel / SOR via dense triangular solves


@partial(jax.tree_util.register_dataclass,
         data_fields=["lower", "upper", "strict_lower", "strict_upper",
                      "diag"],
         meta_fields=["omega", "ordering"])
@dataclasses.dataclass(frozen=True)
class SequentialGSState:
    """Dense split A = L + D + U for triangular-solve sweeps.

    A forward lexicographic Gauss-Seidel sweep is exactly the lower
    triangular solve ``(D + L) u' = b - U u`` and the backward sweep is
    ``(D + U) u' = b - L u`` — identical recurrences to the reference's
    forwardsweep/backwardsweep (smoother.hpp:148-174), vectorized.
    Dense storage bounds this mode to small/medium levels (parity runs).
    """

    lower: jnp.ndarray          # D + L
    upper: jnp.ndarray          # D + U
    strict_lower: jnp.ndarray   # L
    strict_upper: jnp.ndarray   # U
    diag: jnp.ndarray
    omega: float
    ordering: str               # "forward" | "backward" | "symmetric"


def _sequential_setup(A: ELL, omega: float, ordering: str) -> SequentialGSState:
    Ad = A.to_dense()
    d = jnp.diagonal(Ad)
    return SequentialGSState(
        lower=jnp.tril(Ad), upper=jnp.triu(Ad),
        strict_lower=jnp.tril(Ad, -1), strict_upper=jnp.triu(Ad, 1),
        diag=d, omega=omega, ordering=ordering)


def _sor_forward(state: SequentialGSState, u, b):
    """(D + wL) u' = w b + ((1-w) D - w U) u ; w=1 reduces to Gauss-Seidel."""
    w = state.omega
    rhs = w * b + (1.0 - w) * state.diag * u - w * (state.strict_upper @ u)
    M = state.strict_lower * w + jnp.diag(state.diag)
    return jax.scipy.linalg.solve_triangular(M, rhs, lower=True)


def _sor_backward(state: SequentialGSState, u, b):
    w = state.omega
    rhs = w * b + (1.0 - w) * state.diag * u - w * (state.strict_lower @ u)
    M = state.strict_upper * w + jnp.diag(state.diag)
    return jax.scipy.linalg.solve_triangular(M, rhs, lower=False)


class SparseGaussSeidel(SmootherBase):
    """Symmetric Gauss-Seidel, sequential-parity mode.

    One iteration = forward sweep (rows 0..n-1) then backward sweep
    (rows n-1..0), matching SparseGaussSeidel::smooth
    (smoother.hpp:189-214). Defaults mirror the reference's AMG-smoother
    ctor: tolerance 1e-9, check-every 0 (never), n_iters 1
    (smoother.hpp:183-187).
    """

    def __init__(self, tolerance=1e-9, compute_error_every_n_iters=0,
                 n_iters=1):
        super().__init__(tolerance, compute_error_every_n_iters, n_iters)

    def setup(self, A: ELL) -> SequentialGSState:
        return _sequential_setup(A, omega=1.0, ordering="symmetric")

    def apply(self, state: SequentialGSState, u, b):
        u = _sor_forward(state, u, b)
        u = _sor_backward(state, u, b)
        return u


class SuccessiveOverRelaxation(SmootherBase):
    """Sequential SOR, forward ordering, relaxation omega in [0, 2].

    Mirrors SuccessiveOverRelaxation (smoother.hpp:271-373) including the
    constructor-time omega validation that raises on omega outside [0, 2]
    (smoother.hpp:286-293). omega=1 is Gauss-Seidel (forward only).
    """

    def __init__(self, omega: float = 1.0, tolerance=1e-9,
                 compute_error_every_n_iters=100, n_iters=1):
        super().__init__(tolerance, compute_error_every_n_iters, n_iters)
        if omega > 2 or omega < 0:
            raise ValueError(
                f"`omega` must be in [0, 2] but got omega={omega}")
        self.omega = omega

    def setup(self, A: ELL) -> SequentialGSState:
        return _sequential_setup(A, omega=self.omega, ordering="forward")

    def apply(self, state: SequentialGSState, u, b):
        return _sor_forward(state, u, b)


# ---------------------------------------------------------------------------
# Multicolor Gauss-Seidel — the production parallel smoother


@partial(jax.tree_util.register_dataclass,
         data_fields=["color_rows", "color_data", "color_cols", "color_diag",
                      "color_valid"],
         meta_fields=["omega", "symmetric", "n_colors"])
@dataclasses.dataclass(frozen=True)
class MulticolorGSState:
    """Per-color row panels of the ELL matrix.

    Rows of one color share no edges, so their Gauss-Seidel updates are
    independent — the sweep becomes ``n_colors`` dense vector steps instead
    of n sequential scalar steps (the data-parallel answer to the reference's
    loop-carried dependency, smoother.hpp:129-174). Panels are padded to a
    common per-color row count for stacking into one (C, R, K) gather.
    """

    color_rows: jnp.ndarray   # (C, R) row indices, padded with row 0
    color_data: jnp.ndarray   # (C, R, K)
    color_cols: jnp.ndarray   # (C, R, K)
    color_diag: jnp.ndarray   # (C, R)
    color_valid: jnp.ndarray  # (C, R) bool mask of real rows
    omega: float
    symmetric: bool
    n_colors: int


class MulticolorGaussSeidel(SmootherBase):
    """Multicolor (red-black for 5-point stencils) Gauss-Seidel with
    optional over-relaxation and symmetric (fwd+bwd color order) sweeps.

    Convergence differs slightly from lexicographic ordering (documented;
    parity tests use SparseGaussSeidel instead). Coloring is computed on the
    host at setup by greedy first-fit over the ELL pattern.
    """

    def __init__(self, omega: float = 1.0, symmetric: bool = True,
                 tolerance=1e-9, compute_error_every_n_iters=0, n_iters=1,
                 colors: np.ndarray | None = None):
        super().__init__(tolerance, compute_error_every_n_iters, n_iters)
        if omega > 2 or omega < 0:
            raise ValueError(
                f"`omega` must be in [0, 2] but got omega={omega}")
        self.omega = omega
        self.symmetric = symmetric
        self._colors = colors

    def setup(self, A: ELL) -> MulticolorGSState:
        n = A.n_rows
        data = np.asarray(A.data)
        cols = np.asarray(A.cols)
        if self._colors is not None:
            colors = np.asarray(self._colors)
        else:
            colors = greedy_coloring(cols, data, n)
        n_colors = int(colors.max()) + 1 if n else 1
        counts = np.bincount(colors, minlength=n_colors)
        R = int(counts.max())
        C = n_colors
        K = A.row_width
        rows_p = np.zeros((C, R), dtype=np.int64)
        valid = np.zeros((C, R), dtype=bool)
        for c in range(C):
            rc = np.nonzero(colors == c)[0]
            rows_p[c, :len(rc)] = rc
            valid[c, :len(rc)] = True
        data_p = data[rows_p]          # (C, R, K)
        cols_p = cols[rows_p]
        row_ids = rows_p[..., None]
        is_diag = cols_p == row_ids
        diag_p = np.where(is_diag, data_p, 0).sum(axis=2)
        data_off = np.where(is_diag, 0, data_p)
        # Padded rows: make them harmless (diag 1, offdiag 0).
        diag_p = np.where(valid, diag_p, 1.0)
        data_off = np.where(valid[..., None], data_off, 0.0)
        dtype = A.dtype
        return MulticolorGSState(
            color_rows=jnp.asarray(rows_p, dtype=jnp.int32),
            color_data=jnp.asarray(data_off, dtype=dtype),
            color_cols=jnp.asarray(cols_p, dtype=jnp.int32),
            color_diag=jnp.asarray(diag_p, dtype=dtype),
            color_valid=jnp.asarray(valid),
            omega=self.omega, symmetric=self.symmetric, n_colors=C)

    @staticmethod
    def refresh_state(state: MulticolorGSState,
                      A_data: jnp.ndarray) -> MulticolorGSState:
        """Jittable value-only state refresh: new ELL values (same pattern)
        -> new color panels. Used by the on-device hierarchy rebuild
        (multigrid.rebuild_hierarchy_values); the host coloring is
        pattern-based and stays valid."""
        rows = state.color_rows
        data_p = A_data[rows]                       # (C, R, K)
        is_diag = state.color_cols == rows[..., None]
        diag = jnp.sum(jnp.where(is_diag, data_p, 0), axis=2)
        off = jnp.where(is_diag, 0, data_p)
        diag = jnp.where(state.color_valid, diag, 1.0)
        off = off * state.color_valid[..., None]
        return dataclasses.replace(state, color_data=off, color_diag=diag)

    @staticmethod
    def _color_update(state: MulticolorGSState, u, b, c: int):
        rows = state.color_rows[c]
        offsum = jnp.sum(state.color_data[c] * u[state.color_cols[c]], axis=1)
        gs = (b[rows] - offsum) / state.color_diag[c]
        new = u[rows] + state.omega * (gs - u[rows])
        new = jnp.where(state.color_valid[c], new, u[rows])
        return u.at[rows].set(new)

    def apply(self, state: MulticolorGSState, u, b):
        order = list(range(state.n_colors))
        if state.symmetric:
            order = order + order[::-1]
        for c in order:
            u = self._color_update(state, u, b, c)
        return u
