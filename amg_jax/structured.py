"""Structured-grid multigrid solver — the performance path.

Same algorithm as amg_jax/multigrid.py (pre-smooth / residual / restrict /
coarse solve / prolong-correct / post-smooth, reference
multigrid.hpp:263-337) but on the structured 9-point representation
(sparse/stencil.py): every level is a (3,3,n,n) coefficient array, smoothing
is four-color Gauss-Seidel over 2-D sub-lattices, and grid transfer is the
tensor-product bilinear stencil. No gathers anywhere — everything is shifted
slices, so XLA fuses the whole V-cycle into elementwise loops.

Also provides mixed-precision iterative refinement (``solve_ir``): V-cycles
run in fast f32 while the outer defect correction accumulates in f64 —
the standard way to reach the reference's 1e-9-scale tolerances
(testlib.cpp:158, 193) while the smoothing work stays in f32.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from amg_jax.models import poisson
from amg_jax.multigrid import SolveResult
from amg_jax.ops.transfer import linear_interp_1d
from amg_jax.sparse.stencil import (Stencil2D, color_masks, gs4_sweep,
                                    gs4_sweep_masked, jacobi_sweep, prolong,
                                    restrict_fw)
from amg_jax.utils.metrics import rss_from_residual


@partial(jax.tree_util.register_dataclass,
         data_fields=["levels", "coarse_lu", "coarse_piv", "P1s", "masks"],
         meta_fields=["sides", "smoother", "lam_maxes"])
@dataclasses.dataclass(frozen=True)
class StencilHierarchy:
    """Structured level hierarchy.

    P1s: dense per-level 1-D transfer matrices (side_f x side_c). Because
    P2d = kron(P1, P1), restriction and prolongation factor into two dense
    matmuls per field (P1^T @ X @ P1 and P1 @ X @ P1^T) with no strided
    access — the dense form of the reference's sparse transfer SpMVs
    (interpolator.hpp:52-68).
    masks: (4, n, n) color masks per level for the masked sweep.
    """

    levels: tuple  # tuple[Stencil2D]
    coarse_lu: jnp.ndarray
    coarse_piv: jnp.ndarray
    P1s: tuple
    masks: tuple
    sides: tuple   # grid side per level
    smoother: str  # 'masked' | 'packed' | 'strided' | 'chebyshev'
    # per-level lambda_max(D^-1 A) bounds (static floats) for the
    # Chebyshev smoother: analytic Fourier-corner bound on const-stencil
    # levels, power-iteration estimate on variable-coefficient ones
    lam_maxes: tuple | None = None

    @property
    def n_levels(self) -> int:
        return len(self.levels)


def max_levels_for_side(side: int) -> int:
    """Number of times side -> (side-1)/2 stays a valid odd grid >= 3."""
    n, L = side, 1
    while n >= 7 and (n - 1) % 2 == 0 and ((n - 1) // 2) % 2 == 1:
        n = (n - 1) // 2
        L += 1
    return L


def build_stencil_hierarchy(side: int, n_levels: int | None = None,
                            dtype=jnp.float32, A_fine=None,
                            smoother: str = "masked") -> StencilHierarchy:
    """Build the structured hierarchy for the side x side interior Poisson
    grid (or a caller-supplied 9-point fine matrix).

    Setup runs on host: Galerkin RAP per level via scipy SpGEMM
    (multigrid.hpp:219-223 pattern) with tensor-product P, then 9-point
    plane extraction. Coarsest level gets a cached dense LU
    (multigrid.hpp:240-243 pattern).

    smoother: 'masked' (XLA full-width masked color updates — default),
    'packed', 'chebyshev' or 'strided' (sub-lattice slicing).
    """
    import scipy.sparse as sp

    from amg_jax.native import bindings

    if n_levels is None:
        n_levels = max_levels_for_side(side)
    if A_fine is None:
        A_fine = poisson.laplacian_scipy(side)
    sides = [side]
    mats = [A_fine.tocsr()]
    native = bindings.available()
    for _ in range(n_levels - 1):
        n = sides[-1]
        if (n - 1) % 2 or n < 3:
            raise ValueError(f"cannot coarsen side {n}; use side = 2^k - 1")
        nc = (n - 1) // 2
        P1 = linear_interp_1d(n, nc)
        P = sp.kron(P1, P1).tocsr()
        if native:
            R = bindings.csr_transpose(P)
            mats.append(bindings.galerkin_rap(R, mats[-1], P))
        else:
            mats.append((P.T @ (mats[-1] @ P)).tocsr())
        sides.append(nc)
    levels = tuple(Stencil2D.from_scipy(M, s, dtype=dtype)
                   for M, s in zip(mats, sides))
    coarse_dense = jnp.asarray(mats[-1].toarray(), dtype=dtype)
    lu, piv = jax.scipy.linalg.lu_factor(coarse_dense)
    P1s = tuple(jnp.asarray(linear_interp_1d(sides[l], sides[l + 1]
                                             ).toarray(), dtype=dtype)
                for l in range(n_levels - 1))
    masks = tuple(color_masks(s, dtype) for s in sides)
    lam_maxes = None
    if smoother == "chebyshev":
        from amg_jax.sparse.stencil import const_lam_max, estimate_lam_max

        # variable-coefficient levels get a setup-time power-iteration
        # estimate (a few SpMVs, fetched once as a static float); const
        # levels the exact analytic bound
        lam_maxes = tuple(
            const_lam_max(S.w33) if S.w33 is not None
            else float(estimate_lam_max(S))
            for S in levels)
    return StencilHierarchy(levels=levels, coarse_lu=lu, coarse_piv=piv,
                            P1s=P1s, masks=masks,
                            sides=tuple(sides), smoother=smoother,
                            lam_maxes=lam_maxes)


def build_stencil_hierarchy_device(side: int, n_levels: int | None = None,
                                   dtype=jnp.float32,
                                   smoother: str = "masked"
                                   ) -> StencilHierarchy:
    """Build the whole Poisson hierarchy ON DEVICE with no materialized
    coefficient planes or masks: every level's operator is EXACTLY the
    closed-form constant stencil (ops/rap.poisson_const_w33 — the
    bitwise-verified Galerkin/bilinear closure), so levels carry only the
    static 3x3 weight tuples (`Stencil2D.const`); the coarsest dense LU is
    densified from those weights, transfers come from device iota, and
    color masks are rebuilt from iota inside any sweep that needs them.

    Memory: materialized (3,3,n,n) planes plus (4,n,n) masks per level
    would take 3.4 GB at 8191^2 that no const-path op ever reads.
    No host sparse assembly and no bulk host->device transfer — setup is
    one small jitted program.
    """
    from amg_jax.ops.rap import interp1d_dense, poisson_const_w33
    from amg_jax.sparse.stencil import const_planes

    if n_levels is None:
        n_levels = max_levels_for_side(side)
    sides = [side]
    for _ in range(n_levels - 1):
        n = sides[-1]
        if (n - 1) % 2 or n < 3:
            raise ValueError(f"cannot coarsen side {n}; use side = 2^k - 1")
        sides.append((n - 1) // 2)
    w33s = poisson_const_w33(side, n_levels)

    @jax.jit
    def _build():
        from amg_jax.ops.rap import planes_to_dense

        coarse = planes_to_dense(const_planes(w33s[-1], sides[-1], dtype))
        lu, piv = jax.scipy.linalg.lu_factor(coarse)
        P1s = tuple(interp1d_dense(sides[l], sides[l + 1], dtype)
                    for l in range(n_levels - 1))
        return lu, piv, P1s

    lu, piv, P1s = _build()
    masks = (None,) * n_levels
    levels = tuple(Stencil2D.const(w, s, dtype=dtype)
                   for s, w in zip(sides, w33s))
    lam_maxes = None
    if smoother == "chebyshev":
        from amg_jax.sparse.stencil import const_lam_max

        lam_maxes = tuple(const_lam_max(w) for w in w33s)
    return StencilHierarchy(levels=levels, coarse_lu=lu, coarse_piv=piv,
                            P1s=P1s, masks=masks, sides=tuple(sides),
                            smoother=smoother, lam_maxes=lam_maxes)


def build_stencil_hierarchy_planes(c_fine, n_levels: int | None = None,
                                   dtype=jnp.float32,
                                   smoother: str = "masked"
                                   ) -> StencilHierarchy:
    """Build a VARIABLE-coefficient hierarchy fully ON DEVICE from fine
    (3,3,n,n) stencil planes: the Galerkin RAP chain runs as the
    closed-form device contraction (ops/rap.rap_stencil_planes — the
    bilinear tensor-product transfer closes over 9-point stencils), the
    coarsest dense LU is densified on device, and transfers come from
    device iota. No host sparse assembly, no bulk host->device transfer —
    the var analog of build_stencil_hierarchy_device, for at-scale
    variable-coefficient problems (models/varcoef.py), whose ~600 MB of
    coefficient planes are generated on the device.

    Reference anchor: the ctor accepts any assembled A and Galerkin-
    coarsens it (multigrid.hpp:151-244); here A arrives as planes.
    """
    side = int(c_fine.shape[-1])
    if n_levels is None:
        n_levels = max_levels_for_side(side)
    sides = [side]
    for _ in range(n_levels - 1):
        n = sides[-1]
        if (n - 1) % 2 or n < 3:
            raise ValueError(f"cannot coarsen side {n}; use side = 2^k - 1")
        sides.append((n - 1) // 2)

    from amg_jax.ops.rap import (interp1d_dense, planes_to_dense,
                                 rap_stencil_planes)

    @jax.jit
    def _build(cf):
        planes = [cf.astype(dtype)]
        for _ in range(n_levels - 1):
            planes.append(rap_stencil_planes(planes[-1]))
        coarse = planes_to_dense(planes[-1])
        lu, piv = jax.scipy.linalg.lu_factor(coarse)
        P1s = tuple(interp1d_dense(sides[l], sides[l + 1], dtype)
                    for l in range(n_levels - 1))
        return tuple(planes), lu, piv, P1s

    planes, lu, piv, P1s = _build(c_fine)
    levels = tuple(Stencil2D(c=p, side=s, w33=None)
                   for p, s in zip(planes, sides))
    masks = (None,) * n_levels
    lam_maxes = None
    if smoother == "chebyshev":
        from amg_jax.sparse.stencil import estimate_lam_max

        lam_maxes = tuple(float(estimate_lam_max(S)) for S in levels)
    return StencilHierarchy(levels=levels, coarse_lu=lu, coarse_piv=piv,
                            P1s=P1s, masks=masks,
                            sides=tuple(sides), smoother=smoother,
                            lam_maxes=lam_maxes)


def _smooth(hier: StencilHierarchy, l: int, u2, b2, sweeps: int,
            omega: float, symmetric: bool):
    S = hier.levels[l]
    if hier.smoother == "strided":
        for _ in range(sweeps):
            u2 = gs4_sweep(S, u2, b2, omega, symmetric)
        return u2
    if hier.smoother == "chebyshev" and (hier.lam_maxes is not None
                                         or S.w33 is not None):
        from amg_jax.sparse.stencil import chebyshev_smooth, const_lam_max

        # per-level static bound: analytic on const levels, setup-time
        # power iteration on variable-coefficient ones (hier.lam_maxes);
        # const-only fallback covers hierarchies deserialized from before
        # lam_maxes existed (checkpoint round-trips)
        if hier.lam_maxes is not None:
            lam = hier.lam_maxes[l]
        else:
            lam = const_lam_max(S.w33)
        for _ in range(sweeps):
            u2 = chebyshev_smooth(S, u2, b2, lam, degree=4)
        return u2
    # mask fallback: plane-free (device-built) hierarchies store no mask
    # arrays — rebuild from iota inside the trace (fuses to predicates)
    masks = hier.masks[l]
    if masks is None:
        from amg_jax.sparse.stencil import color_masks_iota

        masks = color_masks_iota(S.side, b2.dtype)
    for _ in range(sweeps):
        u2 = gs4_sweep_masked(S, u2, b2, masks, omega, symmetric)
    return u2


# f32 matmuls run at full f32 precision: at the default precision a GPU
# may take them in TF32 (about three decimal digits), which would perturb
# the transfers and with them the cycle counts.
_MM_PRECISION = jax.lax.Precision.HIGHEST


def restrict_mm(r2, P1):
    """R @ r via the tensor-product factorization: P1^T @ r2 @ P1 (two
    matmuls; equals restrict_fw since R2d = kron(P1, P1)^T)."""
    mm = partial(jnp.matmul, precision=_MM_PRECISION)
    return mm(mm(P1.T, r2), P1)


def prolong_mm(uc2, P1):
    """P @ u_c via P1 @ uc2 @ P1^T."""
    mm = partial(jnp.matmul, precision=_MM_PRECISION)
    return mm(mm(P1, uc2), P1.T)


def vcycle_stencil(hier: StencilHierarchy, u2, b2, pre_sweeps: int = 1,
                   post_sweeps: int = 1, omega: float = 1.0,
                   symmetric: bool = True):
    """One structured V-cycle (leg order of multigrid.hpp:263-305)."""
    L = hier.n_levels
    us = [None] * L
    bs = [None] * L
    us[0], bs[0] = u2, b2
    for l in range(L - 1):
        S = hier.levels[l]
        us[l] = _smooth(hier, l, us[l], bs[l], pre_sweeps, omega, symmetric)
        r = bs[l] - S.matvec2(us[l])
        bs[l + 1] = restrict_mm(r, hier.P1s[l])
        us[l + 1] = jnp.zeros_like(bs[l + 1])
    nc = hier.sides[-1]
    sol = jax.scipy.linalg.lu_solve((hier.coarse_lu, hier.coarse_piv),
                                    bs[L - 1].reshape(-1))
    us[L - 1] = sol.reshape(nc, nc)
    for l in range(L - 2, -1, -1):
        us[l] = us[l] + prolong_mm(us[l + 1], hier.P1s[l])
        us[l] = _smooth(hier, l, us[l], bs[l], post_sweeps, omega, symmetric)
    return us[0]


# Packed levels below this side run the masked machinery instead: the
# fields there are a few hundred KB and the per-level pack of the dense
# restriction output stops paying. Not tuned on the GPU.
PACKED_MIN_SIDE = 200

# explicit smoother names StructuredSolver accepts besides 'auto'
SMOOTHERS = ("packed", "masked", "chebyshev", "strided")


def vcycle_packed(hier: StencilHierarchy, u2, b2, pre_sweeps: int = 1,
                  post_sweeps: int = 1, omega: float = 1.0,
                  symmetric: bool = True, _level: int = 0,
                  _packed_in: bool = False, min_side: int | None = None):
    """V-cycle with color-packed smoothing/residual/transfer
    (sparse/packed.py) on constant-stencil levels of side >= min_side:
    each color step evaluates the 9-point stencil at only the n^2/4
    points it updates. Identical leg order and iterates to vcycle_stencil
    (up to fp reassociation; tests/test_packed.py asserts 1e-12
    agreement).

    Levels below min_side — where the masked sweep's fusion is already
    near speed-of-light — run the masked machinery (cycle_stencil) from
    there down. Constant-stencil levels use the static w33; variable
    levels pack their coefficient planes (pack_planes — loop-invariant,
    so XLA hoists the pack out of solve loops). When ``_packed_in`` is
    True, u2/b2 arrive packed ((4, M, M)) and the result returns packed:
    the device solve loop keeps its whole state packed and pays
    pack/unpack once per SOLVE (an odd-size full-field relayout measures
    ~10-50x one sweep — never put one in the cycle)."""
    from amg_jax.sparse.packed import (gs4_sweep_packed,
                                       gs4_sweep_packed_var, pack,
                                       pack_planes, prolong_add_packed,
                                       residual_packed, residual_packed_var,
                                       restrict_packed, unpack)

    if min_side is None:
        min_side = PACKED_MIN_SIDE
    l = _level
    L = hier.n_levels
    S = hier.levels[l]
    if l == L - 1:
        # coarsest level: dense direct solve (also reachable packed when
        # the whole hierarchy is one level)
        from amg_jax.sparse.packed import pack as _pack
        from amg_jax.sparse.packed import unpack as _unpack

        nc = hier.sides[-1]
        ml = (nc - 1) // 2
        bd = _unpack(b2, ml) if _packed_in else b2
        sol = jax.scipy.linalg.lu_solve((hier.coarse_lu, hier.coarse_piv),
                                        bd.reshape(-1)).reshape(nc, nc)
        return _pack(sol, ml) if _packed_in else sol
    if not _packed_in and S.side < min_side:
        # masked machinery from here down
        return cycle_stencil(hier, u2, b2, 1, pre_sweeps, post_sweeps,
                             omega, symmetric, _level=l)
    m = (S.side - 1) // 2
    if S.w33 is not None:
        def sweep(u4_, b4_):
            return gs4_sweep_packed(u4_, b4_, S.w33, m, omega, symmetric)

        def resid(u4_, b4_):
            return residual_packed(u4_, b4_, S.w33, m)
    else:
        cp = pack_planes(S.c, m)

        def sweep(u4_, b4_):
            return gs4_sweep_packed_var(cp, u4_, b4_, m, omega, symmetric)

        def resid(u4_, b4_):
            return residual_packed_var(cp, u4_, b4_, m)
    if _packed_in:
        u4, b4 = u2, b2
    else:
        u4 = pack(u2, m)
        b4 = pack(b2, m)
    for _ in range(pre_sweeps):
        u4 = sweep(u4, b4)
    r4 = resid(u4, b4)
    bc = restrict_packed(r4, m)  # dense (m, m) coarse field
    uc = vcycle_packed(hier, jnp.zeros_like(bc), bc, pre_sweeps,
                       post_sweeps, omega, symmetric, _level=l + 1,
                       min_side=min_side)
    u4 = prolong_add_packed(u4, uc, m)
    for _ in range(post_sweeps):
        u4 = sweep(u4, b4)
    if _packed_in:
        return u4
    return unpack(u4, m)


def cycle_stencil(hier: StencilHierarchy, u2, b2, gamma: int = 1,
                  pre_sweeps: int = 1, post_sweeps: int = 1,
                  omega: float = 1.0, symmetric: bool = True,
                  _level: int = 0):
    """Generalized multigrid cycle: gamma=1 is the V-cycle
    (== vcycle_stencil, the reference's only cycle type,
    multigrid.hpp:263-305), gamma=2 the W-cycle — the coarse problem is
    visited gamma times per level, strengthening the cycle for harder
    problems at ~2x coarse-level cost. Static recursion over the level
    index (unrolls under jit)."""
    l = _level
    L = hier.n_levels
    if l == L - 1:
        nc = hier.sides[-1]
        sol = jax.scipy.linalg.lu_solve((hier.coarse_lu, hier.coarse_piv),
                                        b2.reshape(-1))
        return sol.reshape(nc, nc)
    S = hier.levels[l]
    u2 = _smooth(hier, l, u2, b2, pre_sweeps, omega, symmetric)
    r = b2 - S.matvec2(u2)
    bc = restrict_mm(r, hier.P1s[l])
    uc = jnp.zeros_like(bc)
    for _ in range(gamma):
        uc = cycle_stencil(hier, uc, bc, gamma, pre_sweeps, post_sweeps,
                           omega, symmetric, _level=l + 1)
    u2 = u2 + prolong_mm(uc, hier.P1s[l])
    return _smooth(hier, l, u2, b2, post_sweeps, omega, symmetric)


def fmg_stencil(hier: StencilHierarchy, b2, cycles_per_level: int = 1,
                pre_sweeps: int = 1, post_sweeps: int = 1,
                omega: float = 1.0, symmetric: bool = True,
                gamma: int = 1, start_level: int = 0,
                min_side: int | None = None):
    """Full multigrid (nested iteration): restrict the RHS down the whole
    hierarchy, solve the coarsest level directly, then interpolate the
    *solution* up level by level, running ``cycles_per_level`` cycles at
    each level on the way.

    One FMG pass costs ~1.5x a single V-cycle but yields an initial guess
    already accurate to discretization order — the classic O(N) multigrid
    start. The reference only solves from a zero guess
    (multigrid.hpp:311-337); this is a fast-start extension, used by
    ``StructuredSolver`` to cut defect-correction steps.

    On packed hierarchies (hier.smoother == 'packed', gamma == 1) the
    per-level cycles run the color-packed V-cycle on every level large
    enough to qualify, so the FMG start costs about one packed V-cycle
    rather than a masked one.
    """
    if min_side is None:
        min_side = PACKED_MIN_SIDE
    use_packed = (hier.smoother == "packed" and gamma == 1)
    L = hier.n_levels
    l0 = start_level  # b2 is the field at this level (packed-path FMG
    # starts at level 1 so the expensive fine level is never smoothed
    # with the masked machinery)
    bs = {l0: b2}
    # the b-chain uses the dense transfer matmuls at full f32 precision
    # (_MM_PRECISION): the same operator as restrict_fw up to rounding
    for l in range(l0, L - 1):
        bs[l + 1] = restrict_mm(bs[l], hier.P1s[l])
    nc = hier.sides[-1]
    u = jax.scipy.linalg.lu_solve((hier.coarse_lu, hier.coarse_piv),
                                  bs[L - 1].reshape(-1)).reshape(nc, nc)
    for l in range(L - 2, l0 - 1, -1):
        u = prolong_mm(u, hier.P1s[l])
        for _ in range(cycles_per_level):
            if (use_packed and hier.sides[l] >= min_side
                    and hier.levels[l].w33 is not None):
                u = vcycle_packed(hier, u, bs[l], pre_sweeps, post_sweeps,
                                  omega, symmetric, _level=l,
                                  min_side=min_side)
            else:
                u = cycle_stencil(hier, u, bs[l], gamma, pre_sweeps,
                                  post_sweeps, omega, symmetric, _level=l)
    return u


def solve_stencil(hier: StencilHierarchy, b2, u0=None, tolerance=1e-9,
                  compute_error_every_n_iters: int = 5, n_iters: int = 100,
                  pre_sweeps: int = 1, post_sweeps: int = 1,
                  omega: float = 1.0, symmetric: bool = True) -> SolveResult:
    """Outer loop with the reference's stopping semantics
    (multigrid.hpp:311-337) on the structured path."""
    S0 = hier.levels[0]
    if u0 is None:
        u0 = jnp.zeros_like(b2)

    # hierarchy/b pass as pytree ARGUMENTS: closure capture would embed
    # every coefficient plane as an HLO constant (~20x module bloat,
    # minutes of extra compile time at 1M dofs)
    @partial(jax.jit, static_argnums=(3,))
    def chunk(h, u, b, k):
        return jax.lax.fori_loop(
            0, k, lambda _, uu: vcycle_stencil(h, uu, b, pre_sweeps,
                                               post_sweeps, omega, symmetric),
            u)

    rss_j = jax.jit(
        lambda S, u, b: rss_from_residual(b - S.matvec2(u)))

    every = compute_error_every_n_iters
    it, error, u = 0, 100.0, u0
    history = []
    while it < n_iters and error > tolerance:
        k = (min(every - (it % every), n_iters - it) if every
             else n_iters - it)
        u = chunk(hier, u, b2, k)
        it += k
        if every and it % every == 0:
            error = float(rss_j(S0, u, b2))
            history.append((it, error))
    return SolveResult(u=u, iterations=it, error=error,
                       converged=error <= tolerance, history=history)


def solve_ir(side: int, b2_f64, hier32: StencilHierarchy | None = None,
             tolerance: float = 1e-9, n_refine: int = 30,
             cycles_per_refine: int = 2, **cycle_kw) -> SolveResult:
    """Mixed-precision iterative refinement: f32 V-cycles inside an f64
    defect-correction loop.

    Reaches f64-level rss (the reference's 1e-9 tolerances) while all the
    hot smoothing work runs in f32. The f64 part is one residual SpMV +
    axpy per refinement step.
    """
    if hier32 is None:
        hier32 = build_stencil_hierarchy(side, dtype=jnp.float32)
    A64 = build_fine_stencil_f64(side)

    @jax.jit
    def residual64(A, u64, b64):
        return b64 - A.matvec2(u64)

    @jax.jit
    def cycles32(h, e2, r32):
        for _ in range(cycles_per_refine):
            e2 = vcycle_stencil(h, e2, r32, **cycle_kw)
        return e2

    u = jnp.zeros_like(b2_f64)
    history = []
    it = 0
    error = 100.0
    for k in range(n_refine):
        r = residual64(A64, u, b2_f64)
        error = float(rss_from_residual(r))
        history.append((it, error))
        if error <= tolerance:
            break
        e = cycles32(hier32, jnp.zeros(r.shape, dtype=jnp.float32),
                     r.astype(jnp.float32))
        u = u + e.astype(jnp.float64)
        it += cycles_per_refine
    return SolveResult(u=u, iterations=it, error=error,
                       converged=error <= tolerance, history=history)


def build_fine_stencil_f64(side: int) -> Stencil2D:
    return Stencil2D.from_scipy(poisson.laplacian_scipy(side), side,
                                dtype=jnp.float64)


class StructuredSolver:
    """Persistent single-device structured solver: hierarchy + jitted
    programs built once, then cheap repeated solves.

    ``solve(b2)`` runs pure-f32 V-cycles to an f32-attainable tolerance;
    ``solve_ir(b2_f64)`` wraps them in f64 defect correction for
    reference-grade (1e-7..1e-9) rss. The per-call work is a handful of
    cached jitted dispatches — no re-tracing (unlike the free functions
    above, which are convenience one-shots).
    """

    def __init__(self, side: int, n_levels: int | None = None,
                 smoother: str | None = None, pre_sweeps: int | None = None,
                 post_sweeps: int | None = None, omega: float | None = None,
                 symmetric: bool | None = None,
                 cycles_per_refine: int | None = None,
                 A_fine=None, A_planes=None,
                 device_setup: bool | None = None,
                 fmg: bool = True, precision: str = "df32", config=None,
                 packed_min_side: int | None = None):
        from amg_jax.ops.rap import poisson_planes

        # Resolution order: explicit argument > config > built-in default
        # (None sentinels — a config must not silently override an
        # explicitly passed argument).
        def _resolve(name, explicit, default):
            if explicit is not None:
                return explicit
            if config is not None:
                v = getattr(config, name, None)
                if v is not None:
                    return v
            return default

        smoother = _resolve("smoother", smoother, "auto")
        pre_sweeps = _resolve("pre_sweeps", pre_sweeps, 1)
        post_sweeps = _resolve("post_sweeps", post_sweeps, 1)
        omega = _resolve("omega", omega, 1.0)
        symmetric = _resolve("symmetric", symmetric, True)
        # f32 cycles per df32 refine: fewer residual + loop-overhead
        # payments per solve. Not tuned on the GPU.
        cycles_per_refine = _resolve("cycles_per_refine",
                                     cycles_per_refine, 3)
        packed_min_side = _resolve("packed_min_side", packed_min_side,
                                   None)

        # smoother='auto' is the color-packed pipeline for constant and
        # variable-coefficient operators alike; the other names remain as
        # explicit overrides.
        if smoother == "auto":
            smoother = "packed"
        if smoother not in SMOOTHERS:
            raise ValueError(f"unknown smoother {smoother!r}; expected "
                             f"'auto' or one of {SMOOTHERS}")
        self.smoother = smoother

        self.side = side
        if device_setup is None:
            device_setup = (A_fine is None
                            and smoother in ("masked", "chebyshev",
                                             "packed"))
        if A_planes is not None:
            # variable-coefficient fine operator supplied as DEVICE
            # (3,3,n,n) planes: on-device Galerkin chain (no host
            # assembly, no bulk host transfer — models/varcoef.py)
            if A_fine is not None:
                raise ValueError("pass A_fine or A_planes, not both")
            self.hier = build_stencil_hierarchy_planes(
                A_planes, n_levels, smoother=smoother)
            A64 = Stencil2D(c=jnp.asarray(A_planes, dtype=jnp.float64),
                            side=side, w33=None)
        elif device_setup and A_fine is None:
            self.hier = build_stencil_hierarchy_device(side, n_levels,
                                                       smoother=smoother)
            from amg_jax.ops.rap import poisson_const_w33

            # plane-free f64 operator: residual/rss use the static
            # weights; the f64 planes would be 4.8 GB at 8191^2
            A64 = Stencil2D.const(poisson_const_w33(side, 1)[0], side,
                                  dtype=jnp.float64)
        else:
            if A_fine is None:
                A_fine = poisson.laplacian_scipy(side)  # built once, shared
            self.hier = build_stencil_hierarchy(side, n_levels,
                                                dtype=jnp.float32,
                                                A_fine=A_fine,
                                                smoother=smoother)
            A64 = Stencil2D.from_scipy(A_fine, side, dtype=jnp.float64)
        self._A64 = A64
        self.cycles_per_refine = cycles_per_refine

        # NOTE: the hierarchy and A64 are jit ARGUMENTS, not closure
        # captures — captured device arrays get inlined as HLO constants,
        # bloating the module ~20x and stalling the compiler at 1M dofs.
        # smoother="packed" swaps the whole cycle for the color-packed
        # variant (stencil evaluated once per point; sparse/packed.py)
        # on levels >= packed_min_side
        pms = (PACKED_MIN_SIDE if packed_min_side is None
               else packed_min_side)
        self.packed_min_side = pms
        if smoother == "packed":
            def _vc(h, u, b):
                return vcycle_packed(h, u, b, pre_sweeps, post_sweeps,
                                     omega, symmetric, min_side=pms)
        else:
            def _vc(h, u, b):
                return vcycle_stencil(h, u, b, pre_sweeps, post_sweeps,
                                      omega, symmetric)

        def cycles32(h, e2, r32):
            # fori_loop, not a Python unroll: the V-cycle body is a large
            # graph (all levels), and tracing/compiling it
            # cycles_per_refine times would multiply the solve-loop
            # program size. One traced body, device-side trip count.
            if cycles_per_refine == 1:
                return _vc(h, e2, r32)
            return jax.lax.fori_loop(
                0, cycles_per_refine, lambda _, e: _vc(h, e, r32), e2)

        @jax.jit
        def refine_step(h, A, u64, b64):
            r = b64 - A.matvec2(u64)
            err = rss_from_residual(r)
            e = cycles32(h, jnp.zeros(r.shape, dtype=jnp.float32),
                         r.astype(jnp.float32))
            return u64 + e.astype(jnp.float64), err

        @jax.jit
        def residual_rss(A, u64, b64):
            return rss_from_residual(b64 - A.matvec2(u64))

        @partial(jax.jit, static_argnums=(4,))
        def solve_loop_f64(h, A, b64, tol, n_refine, rtol=0.0):
            """Whole defect-correction solve as ONE device program
            (lax.while_loop): no host round-trip per refinement step. The
            loop-carried error lags the iterate by one step (it is the rss
            of u *before* the latest correction), so the loop may run one
            refinement past convergence; the final exact rss is computed
            after exit."""

            tol_eff = jnp.maximum(tol, rtol * rss_from_residual(b64))

            def cond(state):
                u, err, it = state
                return (err > tol_eff) & (it < n_refine)

            def body(state):
                u, _, it = state
                r = b64 - A.matvec2(u)
                err = rss_from_residual(r)
                e = cycles32(h, jnp.zeros(r.shape, dtype=jnp.float32),
                             r.astype(jnp.float32))
                return u + e.astype(jnp.float64), err, it + 1

            if fmg:
                # nested-iteration start: one f32 FMG pass (~1.5 V-cycles)
                # lands within discretization accuracy, cutting the number
                # of defect-correction steps roughly in half vs u0 = 0
                u0 = fmg_stencil(h, b64.astype(jnp.float32), 1, pre_sweeps,
                                 post_sweeps, omega,
                                 symmetric).astype(jnp.float64)
            else:
                u0 = jnp.zeros_like(b64)
            init = (u0, jnp.asarray(jnp.inf, dtype=b64.dtype),
                    jnp.asarray(0, dtype=jnp.int32))
            u, _, it = jax.lax.while_loop(cond, body, init)
            final_err = rss_from_residual(b64 - A.matvec2(u))
            # err and iteration count packed into ONE device array: each
            # separate scalar fetch costs a host<->device round trip
            return u, jnp.stack([final_err, it.astype(jnp.float64)])

        A64_w33 = A64.w33

        @partial(jax.jit, static_argnums=(4,))
        def solve_loop_df32(h, A_c_df, b64, tol, n_refine, rtol=0.0):
            """Defect-correction solve with the f64 residual replaced by
            double-float32 arithmetic (ops/doublefloat.py): ~2^-48
            relative accuracy from f32 arithmetic only. Same lagged-error
            loop shape as solve_loop_f64. Constant-stencil fine operators
            use exact scalar (hi, lo) weight pairs — the residual then
            reads no coefficient planes at all."""
            from amg_jax.ops.doublefloat import (DF32, df_add_f32,
                                                 df_residual,
                                                 df_residual_const, df_rss,
                                                 df_rss_fast)

            b_df = DF32.from_f64(b64)

            def residual(u):
                if A64_w33 is not None:
                    return df_residual_const(A64_w33, b_df, u)
                return df_residual(A_c_df, b_df, u)

            # relative mode: err <= rtol * rss(b) (rss at u = 0); the
            # absolute tol dominates when rtol = 0 (reference semantics)
            tol_eff = jnp.maximum(tol, rtol * df_rss_fast(b_df))

            def cond(state):
                u, err, it = state
                return (err > tol_eff) & (it < n_refine)

            def body(state):
                u, _, it = state
                r = residual(u)
                err = df_rss_fast(r)
                e = cycles32(h, jnp.zeros_like(r.hi), r.hi)
                return df_add_f32(u, e), err, it + 1

            if fmg:
                u0 = DF32.from_f32(
                    fmg_stencil(h, b_df.hi, 1, pre_sweeps, post_sweeps,
                                omega, symmetric))
            else:
                u0 = DF32.from_f32(jnp.zeros_like(b_df.hi))
            init = (u0, jnp.asarray(jnp.inf, dtype=jnp.float64),
                    jnp.asarray(0, dtype=jnp.int32))
            u, _, it = jax.lax.while_loop(cond, body, init)
            final_err = df_rss(residual(u))
            return u.to_f64(), jnp.stack([final_err,
                                          it.astype(jnp.float64)])

        # Packed-state device loop: when the fine level is packed-eligible
        # the WHOLE defect-correction state (u, b, residual) stays
        # color-packed across the while_loop — df32 residual + rss in
        # packed form (sparse/packed.py), pack/unpack exactly once per
        # solve. This is what makes the packed smoother win end-to-end:
        # an odd-size full-field relayout per step would cost more than
        # the sweeps it saves.
        # >= 2 levels: the packed FMG start runs the coarse hierarchy
        # from start_level=1 (a 1-level "hierarchy" is just a dense solve)
        use_packed_loop = (smoother == "packed" and A64_w33 is not None
                           and side >= pms and len(self.hier.sides) >= 2)
        if use_packed_loop:
            m_f = (side - 1) // 2

            def cycles32_p(h, e4, r4hi):
                def one(e):
                    return vcycle_packed(h, e, r4hi, pre_sweeps,
                                         post_sweeps, omega, symmetric,
                                         _packed_in=True, min_side=pms)

                # single traced V-cycle body (see cycles32)
                if cycles_per_refine == 1:
                    return one(e4)
                return jax.lax.fori_loop(0, cycles_per_refine,
                                         lambda _, e: one(e), e4)

            @partial(jax.jit, static_argnums=(3,))
            def solve_core_packed(h, b4, tol, n_refine, rtol=0.0):
                """The while_loop solve on an ALREADY packed df32 rhs:
                the repeated-solve production form (prepare_b once, solve
                many) — the f64 split + pack/unpack conversions are
                amortizable across solves like the hierarchy setup. Returns the packed df32
                iterate (finalize_u converts when the caller needs
                f64)."""
                from amg_jax.ops.doublefloat import (DF32, df_add_f32,
                                                     df_rss_fast)
                from amg_jax.sparse.packed import df_residual_const_packed

                def residual_hi_rss(u4):
                    r = df_residual_const_packed(A64_w33, b4, u4, m_f)
                    return r.hi, df_rss_fast(r)

                tol_eff = jnp.maximum(tol, rtol * df_rss_fast(b4))

                def cond(state):
                    u4, err, it = state
                    return (err > tol_eff) & (it < n_refine)

                def body(state):
                    u4, _, it = state
                    r_hi, err = residual_hi_rss(u4)

                    # the loop-carried err lags one step, so the loop
                    # would run one full refinement past convergence;
                    # skip the cycles (not the rss) once converged — the
                    # overshoot iteration then costs one residual
                    # instead of a whole refine
                    def refine(u_in):
                        e4 = cycles32_p(h, jnp.zeros_like(r_hi), r_hi)
                        return df_add_f32(u_in, e4)

                    did = err > tol_eff
                    u_next = jax.lax.cond(did, refine,
                                          lambda u_in: u_in, u4)
                    # count only refinements that actually cycled (the
                    # skipped overshoot step does no V-cycle work)
                    return u_next, err, it + did.astype(jnp.int32)

                if fmg:
                    # full nested-iteration start, fine level in PACKED
                    # form: restrict b (packed) to level 1, FMG the
                    # coarse hierarchy with the masked machinery (cheap
                    # at <= side/2), prolong back packed, then ONE packed
                    # fine-level cycle — the standard FMG fine pass.
                    from amg_jax.sparse.packed import (prolong_add_packed,
                                                       restrict_packed)

                    bc = restrict_packed(b4.hi, m_f)
                    uc = fmg_stencil(h, bc, 1, pre_sweeps, post_sweeps,
                                     omega, symmetric, start_level=1,
                                     min_side=pms)
                    u0f = prolong_add_packed(jnp.zeros_like(b4.hi), uc,
                                             m_f)
                    u0f = vcycle_packed(h, u0f, b4.hi, pre_sweeps,
                                        post_sweeps, omega, symmetric,
                                        _packed_in=True, min_side=pms)
                    u0 = DF32.from_f32(u0f)
                else:
                    u0 = DF32.from_f32(jnp.zeros_like(b4.hi))
                init = (u0, jnp.asarray(jnp.inf, dtype=jnp.float64),
                        jnp.asarray(0, dtype=jnp.int32))
                u4, err_out, it = jax.lax.while_loop(cond, body, init)
                # the lagged-error loop always EXITS through a skip
                # iteration when it converges (a refining iteration leaves
                # err > tol in the state), so the state err is exactly
                # rss(u_final) — recompute only on budget exhaustion
                final_err = jax.lax.cond(
                    err_out <= tol_eff, lambda: err_out,
                    lambda: residual_hi_rss(u4)[1])
                return u4, jnp.stack([final_err, it.astype(jnp.float64)])

            @jax.jit
            def prepare_b_j(b64):
                from amg_jax.ops.doublefloat import DF32
                from amg_jax.sparse.packed import pack

                b_df = DF32.from_f64(b64)
                return DF32(hi=pack(b_df.hi, m_f), lo=pack(b_df.lo, m_f))

            @jax.jit
            def finalize_u_j(u4_df):
                from amg_jax.sparse.packed import unpack

                return (unpack(u4_df.hi, m_f).astype(jnp.float64)
                        + unpack(u4_df.lo, m_f).astype(jnp.float64))

            @partial(jax.jit, static_argnums=(4,))
            def solve_loop_df32_packed(h, A_c_df, b64, tol, n_refine,
                                       rtol=0.0):
                u4, stats = solve_core_packed(h, prepare_b_j(b64), tol,
                                              n_refine, rtol)
                return finalize_u_j(u4), stats

            self._prepare_b_j = prepare_b_j
            self._finalize_u_j = finalize_u_j
            self._solve_core_j = solve_core_packed
        else:
            solve_loop_df32_packed = None
            self._prepare_b_j = None
            self._finalize_u_j = None
            self._solve_core_j = None

        self._cycles32 = jax.jit(cycles32)
        self._refine_step_j = refine_step
        self._residual_rss_j = residual_rss

        # rtol base mirroring the ACTIVE device loop's own computation:
        # the loops threshold against df_rss_fast of the
        # df32-split (packed) b, not an exact f64 sum — near the
        # threshold the two can disagree, so solve_ir_fused's converged
        # flag must use the identical value.
        from amg_jax.ops.doublefloat import DF32 as _DF32
        from amg_jax.ops.doublefloat import df_rss_fast as _df_rss_fast
        if precision == "df32" and use_packed_loop:
            self._rtol_base_j = jax.jit(
                lambda b64: _df_rss_fast(prepare_b_j(b64)))
        elif precision == "df32":
            self._rtol_base_j = jax.jit(
                lambda b64: _df_rss_fast(_DF32.from_f64(b64)))
        else:
            self._rtol_base_j = jax.jit(
                lambda b64: rss_from_residual(b64))
        if precision == "df32":
            from amg_jax.ops.doublefloat import DF32

            # const fine operators never read the df plane split (the
            # residual uses exact static (hi, lo) weight pairs)
            self._A_df = (None if A64.w33 is not None
                          else DF32.from_f64(A64.c))
            self._solve_loop_j = (solve_loop_df32_packed
                                  if use_packed_loop else solve_loop_df32)
        elif precision == "f64":
            self._A_df = None
            self._solve_loop_j = solve_loop_f64
        else:
            raise ValueError(f"unknown precision {precision!r}; "
                             "expected 'df32' or 'f64'")
        self.precision = precision

    def _refine_step(self, u64, b64):
        return self._refine_step_j(self.hier, self._A64, u64, b64)

    def _residual_rss(self, u64, b64):
        return self._residual_rss_j(self._A64, u64, b64)

    def _solve_loop(self, b64, tol, n_refine, rtol=0.0):
        A = self._A_df if self.precision == "df32" else self._A64
        return self._solve_loop_j(self.hier, A, b64, tol, n_refine, rtol)

    def warmup(self, refine_step: bool = False):
        """Compile the solve-loop program (first call is slow on a cold
        cache); ``refine_step=True`` additionally compiles the host-
        stepped debug loop's program — skipped by default since the
        production paths never run it.

        Syncs by fetching the small stats array."""
        z64 = jnp.zeros((self.side, self.side), dtype=jnp.float64)
        if refine_step:
            _, err = self._refine_step(z64, z64)
            np.asarray(err)
        _, stats = self._solve_loop(z64, 1e-7, 40)
        np.asarray(stats)

    def prepare_b(self, b2_f64):
        """One-time RHS preparation for the repeated-solve form: f64 ->
        packed df32 (the conversions are amortizable across solves exactly
        like the hierarchy setup).
        Returns an opaque prepared rhs for solve_ir_device_prepared."""
        if self._prepare_b_j is None:
            raise ValueError("prepared-rhs path requires the packed df32 "
                             "solve loop (smoother='auto'/'packed', "
                             "const fine operator)")
        return self._prepare_b_j(b2_f64)

    def solve_ir_device_prepared(self, b4_df, tolerance: float = 1e-7,
                                 n_refine: int = 40, rtol: float = 0.0):
        """Device solve on a prepared rhs: returns ``(u4_df, stats)``
        with the iterate still in packed df32 form — feed it to
        ``finalize_u`` for the f64 field, or keep it packed to pipeline
        into a following solve (e.g. time stepping)."""
        return self._solve_core_j(self.hier, b4_df, tolerance, n_refine,
                                  rtol)

    def finalize_u(self, u4_df):
        return self._finalize_u_j(u4_df)

    def solve_ir_device(self, b2_f64, tolerance: float = 1e-7,
                        n_refine: int = 40, rtol: float = 0.0):
        """Device-only solve: one dispatch, NO host synchronization.

        Returns ``(u, stats)`` device arrays where ``stats = [final_rss,
        n_refine_steps]``. Convergence control runs entirely on device
        (lax.while_loop); use this form to pipeline solves or to time the
        device program without paying scalar-fetch round trips.
        """
        return self._solve_loop(b2_f64, tolerance, n_refine, rtol)

    def solve_ir_fused(self, b2_f64, tolerance: float = 1e-7,
                       n_refine: int = 40,
                       rtol: float = 0.0) -> SolveResult:
        """One-dispatch device-resident solve + a single packed stats fetch
        (see solve_loop_*).

        ``iterations`` counts refinement-loop V-cycles only; the FMG start
        pass (``fmg=True``, ~1.5 V-cycle-equivalents) is excluded, and
        ``history`` holds the single final (iterations, rss) point since the
        loop never synchronizes with the host.
        """
        u, stats = self._solve_loop(b2_f64, tolerance, n_refine, rtol)
        err_v, it_v = np.asarray(stats)  # ONE host round trip
        error = float(err_v)
        iters = int(it_v) * self.cycles_per_refine
        tol_eff = tolerance
        if rtol > 0.0:
            # mirror the device loop's effective tolerance max(tol,
            # rtol * rss(b)) using the SAME reduction the loop runs
            # (df_rss_fast on the df32-split/packed b — an exact f64
            # sum can disagree near the threshold); one extra
            # reduce+fetch, rtol only
            tol_eff = max(tolerance,
                          rtol * float(self._rtol_base_j(b2_f64)))
        return SolveResult(u=u, iterations=iters, error=error,
                           converged=error <= tol_eff,
                           history=[(iters, error)])

    def solve_ir(self, b2_f64, tolerance: float = 1e-7,
                 n_refine: int = 40) -> SolveResult:
        u = jnp.zeros_like(b2_f64)
        history = []
        it = 0
        error = float("inf")
        for _ in range(n_refine):
            u_next, err = self._refine_step(u, b2_f64)
            error = float(err)
            history.append((it, error))
            if error <= tolerance:
                break
            u = u_next
            it += self.cycles_per_refine
        return SolveResult(u=u, iterations=it, error=error,
                           converged=error <= tolerance, history=history)
