"""Worker for the multi-process distributed test (run via subprocess by
tests/test_multiprocess.py, one invocation per simulated host).

Each process owns 2 virtual CPU devices; jax.distributed stitches them into
one global runtime (the multi-host pattern of SURVEY.md §4: N-host
partitioning, halo exchange, and agglomeration tested without a pod).
Process 0 cross-checks the distributed rss trajectory against the
single-device structured solver computed locally.

Usage: python mp_worker.py <process_id> <num_processes> <port>
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def main():
    pid, nproc, port = (int(a) for a in sys.argv[1:4])
    from amg_jax.parallel.launch import initialize_distributed

    info = initialize_distributed(f"localhost:{port}", nproc, pid)
    assert info["process_count"] == nproc, info
    assert info["global_devices"] == 2 * nproc, info

    import jax.numpy as jnp
    import numpy as np

    from amg_jax.models import poisson
    from amg_jax.parallel.structured_dist import DistStructuredSolver

    side = 31
    D = info["global_devices"]
    solver = DistStructuredSolver(side, n_devices=D, dtype=jnp.float64)
    b2 = poisson.rhs(side, dtype=jnp.float64).reshape(side, side)
    b_pad = solver.pad_field(b2)
    u = jnp.zeros_like(b_pad)
    history = []
    for _ in range(10):
        u = solver.vcycle(u, b_pad)
        history.append(solver.rss(u, b_pad))

    # full-FIELD equivalence across processes: every
    # process gathers the sharded iterate (its own shards are the only
    # addressable ones under jax.distributed — process_allgather is the
    # cross-host collective fetch) and checks it against the single-device
    # solve computed locally.
    from jax.experimental import multihost_utils

    u_full = np.asarray(
        multihost_utils.process_allgather(u, tiled=True))[:side, :side]

    from amg_jax.structured import build_stencil_hierarchy, solve_stencil

    hier = build_stencil_hierarchy(side,
                                   n_levels=len(solver.cfg.sides),
                                   dtype=jnp.float64)
    res = solve_stencil(hier, b2, tolerance=0.0,
                        compute_error_every_n_iters=1, n_iters=10)
    scale = float(np.abs(np.asarray(res.u)).max())
    np.testing.assert_allclose(u_full, np.asarray(res.u),
                               rtol=0, atol=1e-10 * scale)
    if pid == 0:
        single = [e for _, e in res.history]
        # below ~1e-13 the rss is pure fp-reassociation noise; compare the
        # meaningful part of the trajectory and require deep convergence
        hi = [(h, s) for h, s in zip(history, single) if s > 1e-13]
        assert len(hi) >= 5, single
        np.testing.assert_allclose([h for h, _ in hi], [s for _, s in hi],
                                   rtol=1e-6)
        assert history[-1] < 1e-12, history[-1]
    print(f"MP_WORKER_OK {pid}", flush=True)


if __name__ == "__main__":
    main()
