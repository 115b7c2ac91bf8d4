"""Krylov acceleration: conjugate gradient preconditioned by one V-cycle.

Extension beyond the reference (which only iterates plain V-cycles,
multigrid.hpp:311-337): using the multigrid cycle as a CG preconditioner is
the standard production configuration for SPD systems — it is robust when
the cycle alone stalls and typically cuts iteration counts further. The
Poisson operator here is symmetric *negative* definite, so CG runs on the
negated system internally.

All device work is jitted; the outer loop follows the reference's stopping
semantics (rss against an absolute tolerance, checked every iteration).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from amg_jax.multigrid import SolveResult
from amg_jax.structured import (StencilHierarchy, vcycle_packed,
                                vcycle_stencil)
from amg_jax.utils.metrics import rss_from_residual


def solve_pcg_stencil(hier: StencilHierarchy, b2, tolerance: float = 1e-9,
                      n_iters: int = 100, u0=None,
                      cycle=None) -> SolveResult:
    """Preconditioned CG on the structured hierarchy (M^-1 = one V-cycle).

    Works on the negated (SPD) system; returns the solution of the original
    one. rss semantics match the reference metric (common.hpp:17-27).
    ``cycle`` selects the preconditioning cycle; by default hierarchies
    built with smoother="packed" precondition with the color-packed
    V-cycle (same GS operator as the masked cycle up to fp reassociation,
    so M stays SPD) and every other smoother setting keeps vcycle_stencil,
    which honors hier.smoother (chebyshev/masked/strided).
    """
    if cycle is None:
        cycle = (vcycle_packed if hier.smoother == "packed"
                 else vcycle_stencil)

    # hierarchy passed as a jit argument (not closure-captured; see the
    # HLO-constant-bloat note in structured.py)
    def A_neg(h, x):  # SPD operator
        return -h.levels[0].matvec2(x)

    def precond(h, r):
        # z = (-A)^-1 r = -(A^-1 r); one V-cycle from zero approximates
        # A^-1 r, and the V-cycle operator is linear in its rhs, so the
        # negation keeps M SPD.
        return -cycle(h, jnp.zeros_like(r), r)

    @jax.jit
    def step(h, state):
        u, r, z, p, it = state
        Ap = A_neg(h, p)
        alpha = jnp.vdot(r, z) / jnp.vdot(p, Ap)
        u = u + alpha * p
        r_new = r - alpha * Ap
        z_new = precond(h, r_new)
        beta = jnp.vdot(r_new, z_new) / jnp.vdot(r, z)
        p = z_new + beta * p
        return (u, r_new, z_new, p, it + 1)

    @jax.jit
    def residual_rss(state):
        return rss_from_residual(state[1])

    @jax.jit
    def init_state(h, b, u0_):
        r0 = -b - A_neg(h, u0_)  # negated system rhs is -b
        z0 = precond(h, r0)
        return (u0_, r0, z0, z0, 0), rss_from_residual(r0)

    if u0 is None:
        u0 = jnp.zeros_like(b2)
    state, err0 = init_state(hier, b2, u0)

    it = 0
    error = float(err0)
    history = [(0, error)]
    while it < n_iters and error > tolerance:
        state = step(hier, state)
        it += 1
        error = float(residual_rss(state))
        history.append((it, error))
    return SolveResult(u=state[0], iterations=it, error=error,
                       converged=error <= tolerance, history=history)


# tolerance is a TRACED operand: marking it static would recompile the
# whole while_loop program per distinct tolerance value; only
# shape-affecting knobs stay static.
@partial(jax.jit, static_argnums=(3, 4))
def _pcg_device(hier, b2, tolerance, n_iters, min_side):
    from amg_jax.structured import PACKED_MIN_SIDE

    pms = PACKED_MIN_SIDE if min_side is None else min_side

    if hier.smoother == "packed":
        def cycle(h, z, r):
            return vcycle_packed(h, z, r, min_side=pms)
    else:
        cycle = vcycle_stencil

    def A_neg(x):
        return -hier.levels[0].matvec2(x)

    def precond(r):
        return -cycle(hier, jnp.zeros_like(r), r)

    r0 = -b2
    z0 = precond(r0)
    tol = jnp.asarray(tolerance, dtype=b2.dtype)

    def cond(state):
        u, r, z, p, it, err = state
        return (err > tol) & (it < n_iters)

    def body(state):
        u, r, z, p, it, _ = state
        Ap = A_neg(p)
        # the two inner products become jax.lax.psum'd partials in the
        # row-partitioned distributed variant — keep them explicit
        alpha = jnp.vdot(r, z) / jnp.vdot(p, Ap)
        u = u + alpha * p
        r_new = r - alpha * Ap
        z_new = precond(r_new)
        beta = jnp.vdot(r_new, z_new) / jnp.vdot(r, z)
        p = z_new + beta * p
        err = rss_from_residual(r_new)
        return (u, r_new, z_new, p, it + 1, err)

    init = (jnp.zeros_like(b2), r0, z0, z0,
            jnp.asarray(0, dtype=jnp.int32), rss_from_residual(r0))
    u, r, z, p, it, err = jax.lax.while_loop(cond, body, init)
    return u, jnp.stack([err, it.astype(b2.dtype)])


def solve_pcg_device(hier: StencilHierarchy, b2, tolerance: float = 1e-7,
                     n_iters: int = 100, min_side: int | None = None):
    """Device-resident PCG: the whole iteration — matvec, V-cycle
    preconditioner, inner products, convergence test — is ONE
    lax.while_loop program; no per-iteration host fetch (the host loop
    above pays a round trip per iteration and remains as the debug
    path).

    Returns ``(u, stats)`` device arrays with ``stats = [rss, iters]``
    — fetch stats once to synchronize (bench.py methodology). f32-native:
    for reference-grade (<=1e-9) tolerances wrap it in defect correction
    (structured.StructuredSolver) instead.
    """
    return _pcg_device(hier, b2, jnp.asarray(tolerance, dtype=b2.dtype),
                       n_iters, min_side)
