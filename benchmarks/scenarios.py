"""Named benchmark scenarios — BASELINE.json configs 1-5.

Each scenario prints one JSON line {"scenario", "metric", "value", "unit",
...extras}. Run all: ``python benchmarks/scenarios.py``; one:
``python benchmarks/scenarios.py ref_testlib``.

1. ref_testlib     — the reference testlib case (35x35, GS, linear-interp
                     V-cycle): iteration-count/rss parity.
2. weighted_jacobi — weighted-Jacobi smoother variant, tunable omega and
                     pre/post sweep counts.
3. large_multicolor— 1023^2+ grid, multicolor GS sweeps: nnz/s.
4. rap_rebuild     — Galerkin RAP rebuild across a deep hierarchy (on-device
                     closed form + native CSR SpGEMM timings).
5. multihost_vcycle— row-partitioned V-cycle with halo exchange and coarse
                     agglomeration over all available devices.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from amg_jax.utils.cache import enable_persistent_cache

enable_persistent_cache()
jax.config.update("jax_enable_x64", True)
if os.environ.get("JAX_PLATFORMS") in ("cpu",):
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np


def emit(**kw):
    dev = jax.devices()[0]
    print(json.dumps(dict(kw, platform=dev.platform,
                          device_kind=dev.device_kind,
                          device_count=len(jax.devices()))), flush=True)


def ref_testlib():
    from amg_jax import Multigrid, SparseGaussSeidel, poisson

    A, b = poisson.poisson2d(35)
    t0 = time.perf_counter()
    amg = Multigrid(None, SparseGaussSeidel(), A, b, 8, 1e-9, 5, 100)
    res = amg.solve(verbose=False)
    emit(scenario="ref_testlib", metric="vcycles_to_1e-9", value=res.iterations,
         unit="iterations", rss=res.error, wall_s=time.perf_counter() - t0,
         reference_iterations=35, reference_rss=7.19199e-11)


def weighted_jacobi():
    from amg_jax import Multigrid, Jacobi, poisson

    A, b = poisson.poisson2d(35)
    best = None
    for omega in (0.6, 0.8, 1.0):
        for sweeps in (1, 2):
            sm = Jacobi(omega=omega, n_iters=sweeps)
            amg = Multigrid(None, sm, A, b, 8, 1e-9, 5, 200)
            res = amg.solve(verbose=False)
            if res.converged and (best is None or res.iterations < best[0]):
                best = (res.iterations, omega, sweeps, res.error)
    emit(scenario="weighted_jacobi", metric="best_vcycles_to_1e-9",
         value=best[0], unit="iterations", omega=best[1], sweeps=best[2],
         rss=best[3])


def large_multicolor():
    from amg_jax.models import poisson
    from amg_jax.sparse.stencil import color_masks, gs4_sweep_masked
    from amg_jax.structured import build_stencil_hierarchy_device

    side = int(os.environ.get("AMG_BENCH_SIDE", "1023"))
    hier = build_stencil_hierarchy_device(side)
    S = hier.levels[0]
    b2 = poisson.rhs(side, dtype=jnp.float32).reshape(side, side)
    masks = hier.masks[0]

    @jax.jit
    def run(S_, b_, m_, u):
        return jax.lax.fori_loop(
            0, 50, lambda _, uu: gs4_sweep_masked(S_, uu, b_, m_), u)

    run = partial_args = lambda u, _r=run: _r(S, b2, masks, u)
    u = run(jnp.zeros_like(b2))
    jax.block_until_ready(u)
    t0 = time.perf_counter()
    u = run(u)
    jax.block_until_ready(u)
    t = (time.perf_counter() - t0) / 50
    nnz = int(np.count_nonzero(np.asarray(S.c)))
    extra = {}
    if jax.devices()[0].platform == "gpu":
        from amg_jax.utils.profiling import peak_for

        # const-stencil sweep traffic: 8 color steps x (read u, b; write
        # u) at the device's published bandwidth
        roof = peak_for(jax.devices()[0].device_kind)
        sol_s = 8 * 3 * side * side * 4 / (roof.hbm_gbps * 1e9)
        extra["sol_pct"] = 100 * sol_s / t
    emit(scenario="large_multicolor", metric="sym_sweep_nnz_per_s",
         value=2 * nnz / t / 1e9, unit="Gnnz/s", side=side,
         sweep_ms=t * 1e3, **extra)


def rap_rebuild():
    from amg_jax.models import poisson
    from amg_jax.native import bindings
    from amg_jax.ops.rap import build_hierarchy_planes, poisson_planes
    from amg_jax.structured import max_levels_for_side

    side = int(os.environ.get("AMG_BENCH_SIDE", "1023"))
    L = max_levels_for_side(side)

    rebuild = jax.jit(
        lambda c: build_hierarchy_planes(c, L)[-1])
    c0 = poisson_planes(side, jnp.float32)
    jax.block_until_ready(rebuild(c0))
    t0 = time.perf_counter()
    for _ in range(5):
        out = rebuild(c0)
    jax.block_until_ready(out)
    dev_ms = (time.perf_counter() - t0) / 5 * 1e3

    host_ms = None
    if bindings.available():
        import scipy.sparse as sp
        from amg_jax.ops.transfer import linear_interp_1d

        t0 = time.perf_counter()
        mats = [poisson.laplacian_scipy(side)]
        s = side
        for _ in range(L - 1):
            nc = (s - 1) // 2
            P1 = linear_interp_1d(s, nc)
            P2 = sp.kron(P1, P1).tocsr()
            mats.append(bindings.galerkin_rap(
                bindings.csr_transpose(P2), mats[-1], P2))
            s = nc
        host_ms = (time.perf_counter() - t0) * 1e3
    emit(scenario="rap_rebuild", metric="device_rap_chain_ms",
         value=round(dev_ms, 2), unit="ms", levels=L, side=side,
         host_native_ms=round(host_ms, 1) if host_ms else None)


def multihost_vcycle():
    from amg_jax.models import poisson
    from amg_jax.parallel.structured_dist import DistStructuredSolver

    side = int(os.environ.get("AMG_DIST_SIDE", "255"))
    D = len(jax.devices())
    dtype = jnp.float32 if jax.devices()[0].platform != "cpu" else jnp.float64
    solver = DistStructuredSolver(side, n_devices=D, dtype=dtype)
    b2 = poisson.rhs(side, dtype=dtype).reshape(side, side)
    b_pad = solver.pad_field(b2)
    u = jnp.zeros_like(b_pad)
    u = solver.vcycle(u, b_pad)
    jax.block_until_ready(u)
    t0 = time.perf_counter()
    for _ in range(20):
        u = solver.vcycle(u, b_pad)
    jax.block_until_ready(u)
    t = (time.perf_counter() - t0) / 20
    emit(scenario="multihost_vcycle", metric="vcycle_ms", value=round(t * 1e3, 3),
         unit="ms", side=side, n_devices=D,
         n_sharded_levels=solver.cfg.n_sharded)


def var_jump():
    """Variable-coefficient jump diffusion: a = 100
    inside the centered square, harmonic-mean faces, hierarchy Galerkin-
    coarsened ON DEVICE, solved with the auto var path (packed-var).
    Size adapts to backend: 255 on a CPU run, 2047 on a GPU. Tolerance is
    the reference's absolute rss 1e-7."""
    from amg_jax.models import poisson
    from amg_jax.models.varcoef import jump_planes
    from amg_jax.structured import StructuredSolver

    on_gpu = jax.default_backend() == "gpu"
    side = 2047 if on_gpu else 255
    b2 = poisson.rhs_device(side, dtype=jnp.float64).reshape(side, side)
    solver = StructuredSolver(side, A_planes=jump_planes(
        side, a_in=100.0, dtype=jnp.float64))
    tol = 1e-7
    u, stats = solver.solve_ir_device(b2, tolerance=tol)
    err_v, it_v = np.asarray(stats)  # warm + sync
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        u, stats = solver.solve_ir_device(b2, tolerance=tol)
        err_v, it_v = np.asarray(stats)
        best = min(best, time.perf_counter() - t0)
    emit(scenario="var_jump", metric="solve_wall_s", value=round(best, 5),
         unit="s", side=side, a_in=100.0, tolerance=tol,
         cycles=int(it_v) * solver.cycles_per_refine, rss=float(err_v),
         smoother=solver.smoother, converged=bool(err_v <= tol))


SCENARIOS = {
    "ref_testlib": ref_testlib,
    "weighted_jacobi": weighted_jacobi,
    "large_multicolor": large_multicolor,
    "rap_rebuild": rap_rebuild,
    "multihost_vcycle": multihost_vcycle,
    "var_jump": var_jump,
}


if __name__ == "__main__":
    names = sys.argv[1:] or list(SCENARIOS)
    for name in names:
        SCENARIOS[name]()
