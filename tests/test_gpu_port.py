"""What the GPU build decides on the host: removed options rejected,
defaults chosen by capability, the peak table, the compile-cache location,
and chip_smoke.py refusing to run without a GPU."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from amg_jax import structured
from amg_jax.parallel.structured_dist import DistStructuredSolver
from amg_jax.utils import cache, profiling

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("smoother", ["fused", "bogus"])
def test_unknown_smoother_rejected(smoother):
    with pytest.raises(ValueError, match="unknown smoother"):
        structured.StructuredSolver(15, smoother=smoother)


@pytest.mark.parametrize("halo", ["rdma", "bogus"])
def test_unknown_halo_rejected(halo):
    with pytest.raises(ValueError, match="unknown halo mode"):
        DistStructuredSolver(31, n_devices=2, halo=halo)


def test_default_halo_on_cpu_mesh():
    s = DistStructuredSolver(31, n_devices=2)
    assert s.cfg.halo == "step"


def test_peak_table_h100():
    r = profiling.peak_for("NVIDIA H100 80GB HBM3")
    assert (r.hbm_gbps, r.f32_tflops) == (3350.0, 67.0)
    assert "H100" in r.source


def test_peak_table_unknown_device_raises():
    with pytest.raises(KeyError, match="no published peaks"):
        profiling.peak_for(jax.devices()[0].device_kind)


def test_cache_dir_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)


def test_cache_dir_default_is_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.cache_dir() == str(REPO / ".jax_cache")


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_cpu():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
