"""Halo-mode crossover under REAL per-collective latency.

On the single-process virtual CPU mesh a ppermute is a memcpy — there
'step' (one exchange per color step, ~17 collectives/level/cycle) beats the
ghost-strip modes ('overlap'/'sweep', ~2/level/cycle) because the ghost
modes pay extended redundant compute instead. The accelerator default
('overlap', structured_dist.default_halo) rests on the analytic prediction
that once each collective costs real latency, the count dominates.

This experiment tests that prediction without several accelerators: each mesh "device"
is its OWN process (jax.distributed over localhost gRPC), so every
collective crosses a process boundary with genuine latency. Compares the
same solver/mode matrix in-process (latency ~ 0) and cross-process
(latency >> 0) and reports the ranking flip.

Usage: python benchmarks/halo_latency.py [side] [iters]
Writes one JSON line per row (scenario 'halo_latency').
"""

import json
import os
import socket
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
sys.path.insert(0, _ROOT)

MODES = ("step", "sweep", "overlap")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_multiprocess(side: int, nproc: int, mode: str, iters: int):
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(_ROOT, "scripts",
                                          "halo_mp_worker.py"),
             str(pid), str(nproc), str(port), str(side), mode,
             str(iters)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env)
        for pid in range(nproc)
    ]
    per = None
    for p in procs:
        out, _ = p.communicate(timeout=600)
        if p.returncode != 0:
            raise RuntimeError(f"worker failed ({mode}):\n{out[-2000:]}")
        for line in out.splitlines():
            if line.startswith("HALO_RESULT 0 "):
                per = float(line.split()[3])
    assert per is not None
    return per


def run_single_process(side: int, nproc: int, mode: str, iters: int):
    """Same measurement on the single-process virtual mesh (latency~0)."""
    out = subprocess.run(
        [sys.executable, "-c", f"""
import os
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={nproc}"
import sys; sys.path.insert(0, {_ROOT!r})
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import time, jax.numpy as jnp
from amg_jax.models import poisson
from amg_jax.parallel.structured_dist import DistStructuredSolver
solver = DistStructuredSolver({side}, n_devices={nproc},
                              dtype=jnp.float64, halo={mode!r})
b2 = poisson.rhs({side}, dtype=jnp.float64).reshape({side}, {side})
b_pad = solver.pad_field(b2)
u = jnp.zeros_like(b_pad)
u = solver.vcycle(u, b_pad)
float(solver.rss(u, b_pad))
t0 = time.perf_counter()
for _ in range({iters}):
    u = solver.vcycle(u, b_pad)
float(solver.rss(u, b_pad))
print("SP_RESULT", (time.perf_counter() - t0) / {iters})
"""],
        capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(out.stdout[-2000:] + out.stderr[-2000:])
    for line in out.stdout.splitlines():
        if line.startswith("SP_RESULT"):
            return float(line.split()[1])
    raise RuntimeError(out.stdout[-2000:])


def main():
    side = int(sys.argv[1]) if len(sys.argv) > 1 else 255
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    nproc = 4
    rows = []
    for mode in MODES:
        t_sp = run_single_process(side, nproc, mode, iters)
        t_mp = run_multiprocess(side, nproc, mode, iters)
        row = {"scenario": "halo_latency", "side": side, "D": nproc,
               "mode": mode, "in_process_s": round(t_sp, 5),
               "cross_process_s": round(t_mp, 5)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    best_sp = min(rows, key=lambda r: r["in_process_s"])["mode"]
    best_mp = min(rows, key=lambda r: r["cross_process_s"])["mode"]
    print(json.dumps({"scenario": "halo_latency_summary", "side": side,
                      "D": nproc, "best_in_process": best_sp,
                      "best_cross_process": best_mp}), flush=True)


if __name__ == "__main__":
    main()
