"""True multi-process distributed test (SURVEY.md §4 implications):
spawn N jax.distributed processes, each owning 2 virtual CPU devices, run
the row-partitioned V-cycle over the 2N-device global mesh, and assert the
rss trajectory matches the single-device solver. Exercises
amg_jax/parallel/launch.py end-to-end — the cross-host pattern the
reference (single-threaded C++) has no analog of."""

import os
import socket
import subprocess
import sys

import pytest

_HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("nproc", [2, 4])
def test_multiprocess_dist_solve(nproc):
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(_HERE, "mp_worker.py"),
             str(pid), str(nproc), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env)
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multi-process workers timed out:\n" + "\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert f"MP_WORKER_OK {pid}" in out, out[-3000:]
