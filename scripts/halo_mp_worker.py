"""Worker for the halo-mode latency experiment (benchmarks/halo_latency.py).

Each process owns ONE virtual CPU device; jax.distributed stitches N of
them into a global mesh, so every collective (ppermute/psum/all_gather)
crosses a real process boundary through the distributed runtime — genuine
nonzero per-collective latency, unlike the single-process virtual mesh
where a ppermute is a memcpy. This is the latency-injection experiment of
as per-collective cost grows, the collective-COUNT
difference between halo modes (per level per sweep: 'step' pays one
exchange per color step, the ghost-strip modes pay one per smooth) must
dominate.

Usage: python halo_mp_worker.py <pid> <nproc> <port> <side> <mode> <iters>
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def main():
    import time

    pid, nproc, port, side, mode, iters = (
        int(a) if a.lstrip("-").isdigit() else a for a in sys.argv[1:7])
    from amg_jax.parallel.launch import initialize_distributed

    initialize_distributed(f"localhost:{port}", nproc, pid)

    import jax.numpy as jnp

    from amg_jax.models import poisson
    from amg_jax.parallel.structured_dist import DistStructuredSolver

    solver = DistStructuredSolver(side, n_devices=nproc,
                                  dtype=jnp.float64, halo=mode)
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    b_pad = solver.pad_field(b2)
    u = jnp.zeros_like(b_pad)
    u = solver.vcycle(u, b_pad)
    float(solver.rss(u, b_pad))  # fetch = sync
    t0 = time.perf_counter()
    for _ in range(iters):
        u = solver.vcycle(u, b_pad)
    err = float(solver.rss(u, b_pad))
    per = (time.perf_counter() - t0) / iters
    print(f"HALO_RESULT {pid} {mode} {per:.6f} {err:.3e}", flush=True)


if __name__ == "__main__":
    main()
