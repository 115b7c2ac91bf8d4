"""Scaling-efficiency harness (BASELINE target: >= 70% nnz/s efficiency at
N >= 2 hosts, row-partitioned levels + halo exchange + agglomeration).

Runs the distributed structured V-cycle at device counts 1..N on whatever
mesh is available and reports per-device-count wall-clock and scaling
efficiency vs the single-device run. On the virtual CPU mesh the numbers
measure orchestration overhead only; on a multi-GPU host the same script
produces the real scaling table.

Usage: python benchmarks/scaling.py [side]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from amg_jax.utils.cache import enable_persistent_cache

enable_persistent_cache()
if os.environ.get("JAX_PLATFORMS") in ("cpu",):
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

from amg_jax.models import poisson
from amg_jax.parallel.structured_dist import DistStructuredSolver


def bench_devices(side: int, D: int, iters: int = 20,
                  halo: str = "overlap", force_var: bool = False) -> float:
    dtype = (jnp.float32 if jax.devices()[0].platform != "cpu"
             else jnp.float64)
    solver = DistStructuredSolver(side, n_devices=D, dtype=dtype,
                                  halo=halo, force_var=force_var)
    b2 = poisson.rhs(side, dtype=dtype).reshape(side, side)
    b_pad = solver.pad_field(b2)
    u = jnp.zeros_like(b_pad)
    u = solver.vcycle(u, b_pad)
    float(solver.rss(u, b_pad))  # scalar fetch: the only reliable sync
    t0 = time.perf_counter()
    for _ in range(iters):
        u = solver.vcycle(u, b_pad)
    float(solver.rss(u, b_pad))
    return (time.perf_counter() - t0) / iters


def bench_ell(D: int, n: int = 63, n_levels: int = 5, iters: int = 20,
              halo: str = "strips") -> float:
    """ELL-path V-cycle time per halo mode."""
    from amg_jax.parallel.ell_dist import EllDistSolver

    dtype = (jnp.float32 if jax.devices()[0].platform != "cpu"
             else jnp.float64)
    A, b = poisson.poisson2d(n)
    solver = EllDistSolver(A, b, n_levels=n_levels, n_devices=D,
                           dtype=dtype, halo=halo)
    b_pad = solver.pad_vec(b)
    u = jnp.zeros_like(b_pad)
    u = solver.vcycle_once(u, b_pad)
    float(solver.rss(u, b_pad))
    t0 = time.perf_counter()
    for _ in range(iters):
        u = solver.vcycle_once(u, b_pad)
    float(solver.rss(u, b_pad))
    return (time.perf_counter() - t0) / iters


def main():
    side = int(sys.argv[1]) if len(sys.argv) > 1 else 255
    avail = len(jax.devices())
    counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= avail]
    t1 = None
    rows = []
    for D in counts:
        t = bench_devices(side, D)
        if t1 is None:
            t1 = t
        eff = t1 / (t * D)
        rows.append(dict(n_devices=D, vcycle_ms=round(t * 1e3, 3),
                         scaling_efficiency=round(eff, 3)))
        print(json.dumps({"scenario": "scaling", "side": side, **rows[-1]}),
              flush=True)

    # halo-mode comparison at the largest device count
    D = counts[-1]
    if D >= 2:
        for halo, fv in (("step", True), ("sweep", False),
                         ("overlap", False), ("sweep", True),
                         ("overlap", True)):
            t = bench_devices(side, D, halo=halo, force_var=fv)
            print(json.dumps({"scenario": "halo_mode", "side": side,
                              "n_devices": D, "halo": halo,
                              "force_var": fv,
                              "vcycle_ms": round(t * 1e3, 3)}), flush=True)
        # same comparison on the banded-window ELL path: per-color-step
        # exchange vs one-ghost-strip-per-sweep
        for halo in ("step", "strips"):
            t = bench_ell(D, halo=halo)
            print(json.dumps({"scenario": "ell_halo_mode", "n": 63,
                              "n_devices": D, "halo": halo,
                              "vcycle_ms": round(t * 1e3, 3)}), flush=True)


if __name__ == "__main__":
    main()
