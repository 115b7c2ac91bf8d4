"""Benchmark of the structured solve on one GPU.

Metric (BASELINE.json): 2-D Poisson V-cycle solve to 1e-7 residual (rss,
the reference's convergence measure, common.hpp:17-27).

  * Device path: ``StructuredSolver(side)`` (color-packed f32 V-cycles
    inside a double-float32 defect-correction loop, all device-resident)
    at 1023^2 (the headline), 2047^2, 4095^2 and 8191^2; the
    jump-coefficient solve at 2047^2; AMG-preconditioned CG in f32; the
    per-sweep cost of each smoother form.
  * Baseline: the same 1023^2 problem solved by the reference-class CPU
    AMG (native C++ replica of the reference's V-cycle + sequential
    symmetric Gauss-Seidel, single thread — amg_jax/native/amgcore.cpp)
    with the same hierarchy and tolerance, on this host.

Prints one JSON line on stdout:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...,
   "device": {...}, "extras": {...}}
vs_baseline = cpu_seconds / device_seconds (higher is better). Details go
to stderr. Every stage that fails raises: the script then exits non-zero
and prints no JSON line. It refuses to run without a GPU.
"""

import json
import subprocess
import sys
import time
from functools import partial

import jax

SIDE = 1023
TOL = 1e-7


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def device_info() -> dict:
    dev = jax.devices()[0]
    limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "power_limit": limit.strip()}


def solve_at(side, n_runs=3):
    """Device-resident solve timings at one size: setup, first call
    (compile), best-of-n wall per solve (each ends in a stats fetch), and
    the prepared-rhs form (f64 -> packed df32 conversion hoisted)."""
    import jax.numpy as jnp
    import numpy as np

    from amg_jax.models import poisson
    from amg_jax.structured import StructuredSolver

    b2 = poisson.rhs_device(side, dtype=jnp.float64).reshape(side, side)
    t0 = time.perf_counter()
    solver = StructuredSolver(side)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver.warmup()
    warmup_s = time.perf_counter() - t0
    times = []
    for _ in range(n_runs):
        t0 = time.perf_counter()
        _, stats = solver.solve_ir_device(b2, tolerance=TOL)
        err_v, it_v = np.asarray(stats)
        times.append(time.perf_counter() - t0)
    assert err_v <= TOL, f"{side}^2 solve did not converge (rss={err_v:.3e})"
    out = dict(wall_s=min(times), setup_s=setup_s, warmup_s=warmup_s,
               cycles=int(it_v) * solver.cycles_per_refine,
               rss=float(err_v))
    if solver._solve_core_j is not None:
        bp = solver.prepare_b(b2)
        np.asarray(solver.solve_ir_device_prepared(bp, tolerance=TOL)[1])
        tp = []
        for _ in range(n_runs):
            t0 = time.perf_counter()
            np.asarray(solver.solve_ir_device_prepared(bp,
                                                       tolerance=TOL)[1])
            tp.append(time.perf_counter() - t0)
        out["prepared_s"] = min(tp)
    log(f"solve {side}^2: {out}")
    return out


def var_solve_at(side, n_runs=3, a_in=100.0):
    """Jump-coefficient solve (a = a_in in the centered square;
    models/varcoef.py), hierarchy Galerkin-coarsened on the device."""
    import jax.numpy as jnp
    import numpy as np

    from amg_jax.models import poisson
    from amg_jax.models.varcoef import jump_planes
    from amg_jax.structured import StructuredSolver

    b2 = poisson.rhs_device(side, dtype=jnp.float64).reshape(side, side)
    t0 = time.perf_counter()
    solver = StructuredSolver(
        side, A_planes=jump_planes(side, a_in=a_in, dtype=jnp.float64))
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.asarray(solver.solve_ir_device(b2, tolerance=TOL)[1])
    warmup_s = time.perf_counter() - t0
    times = []
    for _ in range(n_runs):
        t0 = time.perf_counter()
        err_v, it_v = np.asarray(solver.solve_ir_device(b2,
                                                        tolerance=TOL)[1])
        times.append(time.perf_counter() - t0)
    assert err_v <= TOL, f"var {side}^2 rss={err_v:.3e}"
    out = dict(wall_s=min(times), setup_s=setup_s, warmup_s=warmup_s,
               cycles=int(it_v) * solver.cycles_per_refine,
               rss=float(err_v))
    log(f"var (jump a={a_in:g}) {side}^2: {out}")
    return out


def pcg_at(side, tol=1e-5, n_runs=3):
    """Device-resident AMG-preconditioned CG in f32; ``tol`` is the
    solver's own (recurrence) rss — an f32 iterate's true rss has a floor
    far above it at these sizes."""
    import jax.numpy as jnp
    import numpy as np

    from amg_jax.krylov import solve_pcg_device
    from amg_jax.models import poisson
    from amg_jax.structured import build_stencil_hierarchy_device

    hier = build_stencil_hierarchy_device(side, smoother="packed")
    b2 = poisson.rhs_device(side, dtype=jnp.float32).reshape(side, side)
    np.asarray(solve_pcg_device(hier, b2, tolerance=tol, n_iters=50)[1])
    times = []
    for _ in range(n_runs):
        t0 = time.perf_counter()
        err_v, it_v = np.asarray(solve_pcg_device(hier, b2, tolerance=tol,
                                                  n_iters=50)[1])
        times.append(time.perf_counter() - t0)
    assert err_v <= tol, f"PCG@{side} rss={err_v:.3e}"
    out = dict(wall_s=min(times), iters=int(it_v), rss=float(err_v))
    log(f"pcg {side}^2: {out}")
    return out


def sweep_stats(side, inner=50):
    """Seconds per symmetric sweep of each smoother form on the fine
    level, from a device loop of ``inner`` sweeps, and the share of the
    3-field-pass traffic bound (read u and b, write u) at the published
    bandwidth."""
    import jax.numpy as jnp
    import numpy as np

    from amg_jax.models import poisson
    from amg_jax.ops.rap import poisson_const_w33
    from amg_jax.sparse.packed import gs4_sweep_packed, pack
    from amg_jax.sparse.stencil import (Stencil2D, color_masks_iota,
                                        gs4_sweep_masked)
    from amg_jax.utils.profiling import peak_for

    roof = peak_for(jax.devices()[0].device_kind)
    w33 = poisson_const_w33(side, 1)[0]
    S = Stencil2D.const(w33, side)
    m = (side - 1) // 2
    b2 = poisson.rhs_device(side, dtype=jnp.float32).reshape(side, side)
    u2 = jnp.zeros_like(b2)
    masks = color_masks_iota(side, jnp.float32)
    forms = {
        "masked": (lambda u, b: gs4_sweep_masked(S, u, b, masks), u2, b2),
        "packed": (lambda u, b: gs4_sweep_packed(u, b, w33, m),
                   pack(u2, m), pack(b2, m)),
    }
    min3_s = 3 * side * side * 4 / (roof.hbm_gbps * 1e9)
    out = {}
    for name, (fn, u, b) in forms.items():
        @partial(jax.jit, static_argnums=(2,))
        def loop(u_, b_, k, fn=fn):
            return jnp.sum(jax.lax.fori_loop(0, k, lambda _, x: fn(x, b_),
                                             u_))

        float(loop(u, b, inner))
        best = min(_timed(lambda: float(loop(u, b, inner)))
                   for _ in range(3)) / inner
        out[name] = dict(sweep_s=best, min3_share=min3_s / best)
    log(f"sweeps {side}^2: {out}")
    return out


def _timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def cpu_baseline(side=SIDE, n_runs=3):
    """Best-of-n seconds of the native reference-class CPU AMG on this
    host; None when the native engine is not built."""
    import numpy as np
    import scipy.sparse as sp

    from amg_jax.models import poisson
    from amg_jax.native import bindings
    from amg_jax.ops.transfer import linear_interp_1d
    from amg_jax.structured import max_levels_for_side

    if not bindings.available():
        log("native baseline unavailable")
        return None
    mats = [poisson.laplacian_scipy(side)]
    Ps, Rs = [], []
    s = side
    for _ in range(max_levels_for_side(side) - 1):
        nc = (s - 1) // 2
        P2 = sp.kron(linear_interp_1d(s, nc), linear_interp_1d(s, nc)).tocsr()
        Ps.append(P2)
        Rs.append(P2.T.tocsr())
        mats.append(bindings.galerkin_rap(Rs[-1], mats[-1], P2))
        s = nc
    b = np.asarray(poisson.rhs(side))
    runs = [bindings.cpu_vcycle_solve(mats, Ps, Rs, b, tol=TOL,
                                      check_every=1, max_iters=100)
            for _ in range(n_runs)]
    secs, iters, rss, _ = min(runs, key=lambda r: r[0])
    assert rss <= TOL, f"cpu baseline did not converge (rss={rss:.3e})"
    log(f"cpu reference-class solve {side}^2 best-of-{n_runs}: {secs:.3f}s "
        f"({iters} cycles, rss={rss:.3e})")
    return secs


def main():
    if jax.devices()[0].platform != "gpu":
        print("bench.py: needs a GPU; JAX found "
              f"{jax.devices()[0].platform!r}", file=sys.stderr)
        return 1
    jax.config.update("jax_enable_x64", True)
    from amg_jax.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    dev = device_info()
    log(f"device: {dev}")
    head = solve_at(SIDE, n_runs=5)
    cpu_s = cpu_baseline()
    extras = {"solve": {side: solve_at(side) for side in (2047, 4095)}}
    extras["solve"][SIDE] = head
    extras["solve"][8191] = solve_at(8191, n_runs=2)
    extras["var_solve"] = {2047: var_solve_at(2047)}
    extras["pcg"] = {side: pcg_at(side) for side in (2047, 4095)}
    extras["sweeps"] = {side: sweep_stats(side) for side in (4095, 8191)}
    extras["cpu_baseline_s"] = cpu_s
    print(json.dumps({
        "metric": f"poisson2d_{SIDE}x{SIDE}_amg_solve_rss1e-7_wall",
        "value": head["wall_s"],
        "unit": "s",
        "vs_baseline": (cpu_s / head["wall_s"]) if cpu_s else None,
        "device": dev,
        "extras": extras,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
