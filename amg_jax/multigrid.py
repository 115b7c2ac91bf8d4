"""Multigrid hierarchy construction, V-cycle, and outer solve loop.

A JAX redesign of include/amg/multigrid.hpp. The reference's stateful
OO solver (per-level Eigen vectors mutated in place) becomes:

  * ``Hierarchy`` — an immutable pytree of ``Level``s (static length, so the
    V-cycle unrolls into one jitted XLA program), each holding the level's
    ELL matrix, transfer operators to the next coarser level, and the
    smoother's per-level state, plus a cached dense LU of the coarsest
    matrix (reference: SimplicialLDLT, multigrid.hpp:240-243).
  * ``vcycle`` — a pure jitted function u -> u over the hierarchy with the
    reference's exact leg order (multigrid.hpp:263-305).
  * ``solve`` — host loop with the reference's stopping semantics
    (multigrid.hpp:311-337): ``while iter < n_iters && error > tol`` with an
    rss check every ``compute_error_every_n_iters`` V-cycles, dispatching
    jitted chunks of V-cycles between checks.

Setup (Galerkin RAP, coloring, factorization) runs on host once — it is the
phase the reference also treats as construction-time (multigrid.hpp:151-244).

Known reference quirk intentionally not replicated: the reference also
smooths the coarsest level and computes its residual on the down-leg before
the direct solve overwrites that solution (multigrid.hpp:265-288) — provably
dead work (the smoothed value is discarded), so we skip it; iteration counts
and solutions are unaffected. Also fixed: ``display_error_off`` in the
reference sets the flag to true (multigrid.hpp:361-364).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from amg_jax.ops.coarse import CoarseSolver, setup_coarse_solver
from amg_jax.ops.smoothers import (MulticolorGaussSeidel, SmootherBase,
                                   SparseGaussSeidel)
from amg_jax.ops.transfer import InterpolatorBase, LinearInterpolator
from amg_jax.sparse.ell import ELL
from amg_jax.utils.metrics import rss, rss_from_residual


def n_H_dofs_from_n_h_dofs(h_dofs: int) -> int:
    """Coarse dof count (Briggs): n_H = (n_h + 1)/2 - 1
    (multigrid.hpp:127-130)."""
    return (h_dofs + 1) // 2 - 1


@partial(jax.tree_util.register_dataclass,
         data_fields=["A", "P", "R", "smoother_state"], meta_fields=[])
@dataclasses.dataclass(frozen=True)
class Level:
    """One multigrid level. P/R map to the next coarser level (None at the
    coarsest), mirroring the per-level maps of multigrid.hpp:83-107."""

    A: ELL
    P: Any  # ELL | None
    R: Any  # ELL | None
    smoother_state: Any


@partial(jax.tree_util.register_dataclass,
         data_fields=["levels", "coarse"], meta_fields=[])
@dataclasses.dataclass(frozen=True)
class Hierarchy:
    levels: tuple
    coarse: CoarseSolver

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def n_dofs(self, level: int) -> int:
        return self.levels[level].A.n_rows


@dataclasses.dataclass
class SolveResult:
    """Structured replacement for the reference's convergence prints
    (multigrid.hpp:323-334)."""

    u: jnp.ndarray
    iterations: int
    error: float
    converged: bool
    history: list  # (iteration, rss) at each check


def galerkin_rap(R: sp.spmatrix, A: sp.spmatrix, P: sp.spmatrix):
    """Galerkin coarse operator A_H = R (A P) — two host SpGEMMs, same
    association order as the reference (multigrid.hpp:219-223)."""
    return (R @ (A @ P)).tocsr()


def build_hierarchy(A, n_levels: int,
                    interpolator: InterpolatorBase | None = None,
                    smoother: SmootherBase | None = None,
                    dtype=None) -> Hierarchy:
    """Construct the level hierarchy (reference ctor, multigrid.hpp:151-244).

    Args:
      A: finest operator — ELL or scipy sparse.
      n_levels: total level count (level 0 = finest).
      interpolator: transfer-operator factory (default LinearInterpolator —
        reference parity). Its per-level P/R maps are also populated, like
        the reference's injected interpolator.
      smoother: smoother whose per-level state to precompute
        (default SparseGaussSeidel()).
      dtype: device dtype (default: A's dtype).
    """
    if interpolator is None:
        interpolator = LinearInterpolator(n_levels)
    if smoother is None:
        smoother = SparseGaussSeidel()
    A_sp = A.to_scipy() if isinstance(A, ELL) else A.tocsr()
    if dtype is None:
        dtype = A.dtype if isinstance(A, ELL) else A_sp.dtype

    mats = [A_sp]
    Ps, Rs = [], []
    for level in range(1, n_levels):
        n_h = mats[-1].shape[0]
        n_H = interpolator.coarse_size(n_h)
        if n_H < 1:
            raise ValueError(
                f"hierarchy too deep: level {level} would have {n_H} dofs "
                f"(finest {A_sp.shape[0]}, requested {n_levels} levels)")
        P, R = interpolator.make_operators_scipy(n_h, n_H)
        interpolator.set_level_to_P(level - 1, ELL.from_scipy(P, dtype=dtype))
        interpolator.set_level_to_R(level - 1, ELL.from_scipy(R, dtype=dtype))
        Ps.append(P)
        Rs.append(R)
        mats.append(galerkin_rap(R, mats[-1], P))

    levels = []
    for l, M in enumerate(mats):
        A_ell = ELL.from_scipy(M, dtype=dtype)
        P_ell = ELL.from_scipy(Ps[l], dtype=dtype) if l < n_levels - 1 else None
        R_ell = ELL.from_scipy(Rs[l], dtype=dtype) if l < n_levels - 1 else None
        levels.append(Level(A=A_ell, P=P_ell, R=R_ell,
                            smoother_state=smoother.setup(A_ell)))
    coarse = setup_coarse_solver(levels[-1].A)
    return Hierarchy(levels=tuple(levels), coarse=coarse)


def build_hierarchy_device(A, n_levels: int,
                           smoother: SmootherBase | None = None,
                           dtype=None):
    """Hierarchy whose Galerkin products run ON DEVICE (ops/ell_rap closed
    form over the reference transfer structure, interpolator.hpp:98-142;
    cf. multigrid.hpp:219-223 host SpGEMM).

    Returns (hierarchy, plans): keep ``plans`` to refresh the hierarchy for
    new operator VALUES with ``rebuild_hierarchy_values`` — one jitted
    dispatch, no host SpGEMM round-trips (BASELINE config 4).
    """
    from amg_jax.ops.ell_rap import build_rap_plans

    if smoother is None:
        smoother = MulticolorGaussSeidel()
    interpolator = LinearInterpolator(n_levels)
    A_ell = A if isinstance(A, ELL) else ELL.from_scipy(A, dtype=dtype)
    if dtype is not None:
        A_ell = A_ell.astype(dtype)
    plans, mats = build_rap_plans(A_ell, n_levels)
    levels = []
    for l, M in enumerate(mats):
        if l < n_levels - 1:
            n_h, n_H = M.n_rows, mats[l + 1].n_rows
            P, R = interpolator.make_operators_scipy(n_h, n_H)
            P_ell = ELL.from_scipy(P, dtype=M.dtype)
            R_ell = ELL.from_scipy(R, dtype=M.dtype)
            interpolator.set_level_to_P(l, P_ell)
            interpolator.set_level_to_R(l, R_ell)
        else:
            P_ell = R_ell = None
        levels.append(Level(A=M, P=P_ell, R=R_ell,
                            smoother_state=smoother.setup(M)))
    coarse = setup_coarse_solver(levels[-1].A)
    return Hierarchy(levels=tuple(levels), coarse=coarse), tuple(plans)


def rebuild_hierarchy_values(hier: Hierarchy, plans: tuple,
                             A_data: jnp.ndarray) -> Hierarchy:
    """Jittable value-only hierarchy refresh: new fine ELL values (same
    sparsity pattern) -> new level operators, smoother panels, and coarse
    LU, entirely on device. The general-path analog of the structured
    closed-form rebuild (ops/rap.build_hierarchy_planes)."""
    from amg_jax.ops.ell_rap import apply_rap_chain
    from amg_jax.ops.smoothers import (MulticolorGaussSeidel,
                                       MulticolorGSState)

    datas = apply_rap_chain(plans, A_data)
    new_levels = []
    for l, lev in enumerate(hier.levels):
        A_new = ELL(data=datas[l], cols=lev.A.cols, shape=lev.A.shape)
        st = lev.smoother_state
        if isinstance(st, MulticolorGSState):
            st = MulticolorGaussSeidel.refresh_state(st, datas[l])
        else:
            raise NotImplementedError(
                "rebuild_hierarchy_values supports MulticolorGaussSeidel "
                "hierarchies (the production smoother); rebuild others "
                "with build_hierarchy_device")
        new_levels.append(dataclasses.replace(lev, A=A_new,
                                              smoother_state=st))
    coarse = setup_coarse_solver(new_levels[-1].A)
    return Hierarchy(levels=tuple(new_levels), coarse=coarse)


def _smooth_level(smoother: SmootherBase, state, u, b):
    """Fixed-sweep in-cycle smoothing: the reference calls
    smoother->smooth() whose while-loop runs exactly n_iters iterations when
    no error cadence is set (smoother.hpp:189-198; SPGS default n_iters=1,
    check-every 0)."""
    for _ in range(smoother.n_iters):
        u = smoother.apply(state, u, b)
    return u


def vcycle(hier: Hierarchy, smoother: SmootherBase, u: jnp.ndarray,
           b: jnp.ndarray, collect: bool = False):
    """One V-cycle (multigrid.hpp:263-305): down-leg pre-smooth + residual +
    restrict, coarsest direct solve, up-leg prolong-correct + post-smooth.

    Pure function of (u, b); per-cycle coarse u/b are locals (the reference
    zeroes coarse solutions each cycle, multigrid.hpp:278). With
    ``collect=True`` also returns per-level (u, b, r) lists for inspection.
    """
    L = hier.n_levels
    us = [None] * L
    bs = [None] * L
    rs = [None] * L
    us[0], bs[0] = u, b
    for l in range(L - 1):
        lev = hier.levels[l]
        us[l] = _smooth_level(smoother, lev.smoother_state, us[l], bs[l])
        rs[l] = bs[l] - lev.A.matvec(us[l])
        bs[l + 1] = lev.R.matvec(rs[l])
        # coarse solution starts at zero each cycle (multigrid.hpp:278)
        us[l + 1] = jnp.zeros_like(bs[l + 1])
    us[L - 1] = hier.coarse.solve(bs[L - 1])
    rs[L - 1] = bs[L - 1] - hier.levels[L - 1].A.matvec(us[L - 1])
    for l in range(L - 2, -1, -1):
        lev = hier.levels[l]
        us[l] = us[l] + lev.P.matvec(us[l + 1])
        us[l] = _smooth_level(smoother, lev.smoother_state, us[l], bs[l])
    if collect:
        return us[0], (us, bs, rs)
    return us[0]


def solve(hier: Hierarchy, smoother: SmootherBase, b: jnp.ndarray,
          u0: jnp.ndarray | None = None, tolerance: float = 1e-9,
          compute_error_every_n_iters: int = 10, n_iters: int = 100,
          display_error: bool = False) -> SolveResult:
    """Outer V-cycle loop (multigrid.hpp:311-337).

    Stopping semantics match the reference exactly: error sentinel 100, rss
    of the finest system checked only every ``compute_error_every_n_iters``
    cycles (0 = never), loop while ``iter < n_iters && error > tolerance``.
    Between checks, V-cycles run as one jitted chunk (lax.fori_loop).
    """
    A0 = hier.levels[0].A
    if u0 is None:
        u0 = jnp.zeros(A0.n_rows, dtype=A0.dtype)

    # hierarchy/b as jit arguments (closure capture would inline the level
    # matrices as HLO constants — large compile-time cost)
    @partial(jax.jit, static_argnums=(3,))
    def cycle_chunk(h, u, bb, k):
        return jax.lax.fori_loop(
            0, k, lambda _, uu: vcycle(h, smoother, uu, bb), u)

    rss_j = jax.jit(lambda A, u, bb: rss(A, u, bb))

    every = compute_error_every_n_iters
    it = 0
    error = 100.0  # reference sentinel (multigrid.hpp:313)
    history = []
    u = u0
    while it < n_iters and error > tolerance:
        if every and every > 0:
            k = min(every - (it % every), n_iters - it)
        else:
            k = n_iters - it
        u = cycle_chunk(hier, u, b, k)
        it += k
        if every and it % every == 0:
            error = float(rss_j(A0, u, b))
            history.append((it, error))
            if display_error:
                print(f"Iter: {it} | Error: {error}")
    converged = error <= tolerance
    return SolveResult(u=u, iterations=it, error=error, converged=converged,
                       history=history)


class Multigrid:
    """Reference-parity OO facade over the functional core
    (class AMG::Multigrid, multigrid.hpp:23-365).

    Construction validates and builds the hierarchy; ``solve`` runs V-cycles
    to tolerance. The injected interpolator/smoother mirror the reference's
    dependency injection (multigrid.hpp:151-156).
    """

    def __init__(self, interpolator: InterpolatorBase | None,
                 smoother: SmootherBase | None, A, b, n_levels: int,
                 tolerance: float = 1e-9,
                 compute_error_every_n_iters: int = 10, n_iters: int = 100,
                 dtype=None, config=None):
        # config.SolverConfig supplies the reference ctor defaults
        # (multigrid.hpp:155-156) when explicit arguments are not given
        if config is not None:
            n_levels = n_levels or config.n_levels
            tolerance = config.tolerance
            compute_error_every_n_iters = \
                config.compute_error_every_n_iters
            n_iters = config.n_iters
        # Validations (multigrid.hpp:164-178).
        if compute_error_every_n_iters > n_iters:
            raise ValueError(
                "`compute_error_every_n_iters` must be leq to `n_iters`, "
                f"got {compute_error_every_n_iters} and {n_iters}")
        n_rows_A = A.n_rows if isinstance(A, ELL) else A.shape[0]
        if n_rows_A != b.shape[0]:
            raise ValueError(
                "`A` and `b` must have the same number of degrees of "
                f"freedom, got {n_rows_A} and {b.shape[0]}")

        self.smoother = smoother if smoother is not None else SparseGaussSeidel()
        self.interpolator = (interpolator if interpolator is not None
                             else LinearInterpolator(n_levels))
        self.tolerance = tolerance
        self.compute_error_every_n_iters = compute_error_every_n_iters
        self.n_iters = n_iters
        self.n_levels = n_levels
        self.hierarchy = build_hierarchy(
            A, n_levels, self.interpolator, self.smoother, dtype=dtype)
        dt = self.hierarchy.levels[0].A.dtype
        self.b = jnp.asarray(b, dtype=dt)
        self._display_error = False
        # Per-level state mirrors (u zero, level rhs/residual zero at build;
        # finest rhs/residual = b: multigrid.hpp:190-236).
        self._us = [jnp.zeros(lev.A.n_rows, dtype=dt)
                    for lev in self.hierarchy.levels]
        self._bs = [self.b] + [jnp.zeros(lev.A.n_rows, dtype=dt)
                               for lev in self.hierarchy.levels[1:]]
        self._rs = list(self._bs)
        # jit built ONCE (a fresh jax.jit closure per call would retrace
        # every vcycle() invocation)
        self._vcycle_j = jax.jit(
            lambda h, u, bb: vcycle(h, self.smoother, u, bb, collect=True))

    # -- reference API ----------------------------------------------------

    def vcycle(self):
        """One stateful V-cycle (updates per-level state like the
        reference's in-place version, multigrid.hpp:263-305)."""
        u0, (us, bs, rs) = self._vcycle_j(self.hierarchy, self._us[0],
                                          self.b)
        self._us, self._bs, self._rs = list(us), list(bs), list(rs)
        return u0

    def solve(self, verbose: bool = True) -> SolveResult:
        """Solve to tolerance (multigrid.hpp:311-337). Returns a
        SolveResult; ``result.u`` is the finest solution."""
        res = solve(self.hierarchy, self.smoother, self.b, u0=self._us[0],
                    tolerance=self.tolerance,
                    compute_error_every_n_iters=self.compute_error_every_n_iters,
                    n_iters=self.n_iters, display_error=self._display_error)
        self._us[0] = res.u
        if verbose:
            word = "converged" if res.converged else "did not converge"
            print(f"AMG {word} after {res.iterations} iterations.")
        return res

    def get_coefficient_matrix(self, level: int) -> ELL:
        return self.hierarchy.levels[level].A

    def get_soln(self, level: int) -> jnp.ndarray:
        return self._us[level]

    def get_rhs(self, level: int) -> jnp.ndarray:
        return self._bs[level]

    def get_residual(self, level: int) -> jnp.ndarray:
        return self._rs[level]

    def get_n_dofs(self, level: int) -> int:
        return self.hierarchy.n_dofs(level)

    def get_tolerance(self) -> float:
        return self.tolerance

    def display_error_on(self):
        self._display_error = True

    def display_error_off(self):
        # The reference's version buggily sets true (multigrid.hpp:361-364);
        # fixed here.
        self._display_error = False
