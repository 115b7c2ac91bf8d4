"""Profiling utilities: nnz/s counters, roofline estimates, trace capture.

The reference's profiling workflow is external (valgrind callgrind +
KCachegrind, README.md:52-78, with the committed
callgrind.out.slow_smoother artifact). The equivalents here (SURVEY.md §5):
``jax.profiler`` traces plus per-kernel throughput counters compared
against the device's published peaks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time

import jax


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Published peaks of one device: memory bandwidth and f32 rate."""

    hbm_gbps: float      # device-memory bandwidth, GB/s
    f32_tflops: float    # dense f32 rate without tensor cores, TFLOP/s
    source: str = ""

    def stencil_sweep_sol_s(self, n_points: int, bytes_per: int = 4,
                            passes: float = 12.0):
        """Speed-of-light seconds for one fused stencil sweep: `passes`
        full-field memory transfers (9 coeff planes + b + u read, u
        write)."""
        return passes * n_points * bytes_per / (self.hbm_gbps * 1e9)


# Published peaks keyed by jax ``device_kind``. A device that is not here
# has no roofline: peak_for raises rather than guess.
PEAKS = {
    "NVIDIA H100 80GB HBM3": Roofline(
        hbm_gbps=3350.0, f32_tflops=67.0,
        source="NVIDIA H100 data sheet, SXM part, 700 W"),
}


def peak_for(device_kind: str) -> Roofline:
    """The published peaks for ``device_kind`` (``jax.devices()[0]
    .device_kind``); KeyError for a device the table does not know."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind "
                       f"{device_kind!r}; known: {sorted(PEAKS)}") from None


@dataclasses.dataclass
class KernelStats:
    name: str
    seconds: float
    nnz: int
    sweeps: int = 1

    @property
    def nnz_per_s(self) -> float:
        return self.nnz * self.sweeps / self.seconds

    def summary(self, roofline: Roofline | None = None,
                n_points: int | None = None) -> str:
        s = (f"{self.name}: {self.seconds*1e3:.3f} ms, "
             f"{self.nnz_per_s/1e9:.2f} Gnnz/s")
        if roofline and n_points:
            sol = roofline.stencil_sweep_sol_s(n_points)
            s += f" ({100*sol/ (self.seconds/self.sweeps):.0f}% of SoL)"
        return s


def time_fn(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Wall-clock a jitted callable (blocks on the result)."""
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture a jax.profiler trace around a block (open with XProf)."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "amg_jax_trace")
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
