"""Configuration dataclasses.

The reference has no config system (SURVEY.md §5) — everything is
constructor arguments with hard defaults (multigrid.hpp:155-156: tol 1e-9,
check-every 10, 100 iters; smoother.hpp:25-37: tol 1e-9, check-every 100,
1 iter; SPGS ctor smoother.hpp:183-187: check-every 0). These dataclasses
centralize the same knobs plus this library's own (dtype, mesh, sweeps,
omega) so parity runs can assert default equality.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class SmootherConfig:
    """Mirrors SmootherBase hyperparameters (smoother.hpp:25-37)."""

    tolerance: float = 1e-9
    compute_error_every_n_iters: int = 100
    n_iters: int = 1
    omega: float = 1.0
    symmetric: bool = True


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Mirrors the Multigrid ctor defaults (multigrid.hpp:155-156)."""

    n_levels: int = 8
    tolerance: float = 1e-9
    compute_error_every_n_iters: int = 10
    n_iters: int = 100


@dataclasses.dataclass(frozen=True)
class StructuredConfig:
    """Structured-path knobs (amg_jax/structured.py)."""

    dtype: object = jnp.float32
    pre_sweeps: int = 1
    post_sweeps: int = 1
    omega: float = 1.0
    symmetric: bool = True
    refine_tolerance: float = 1e-9
    cycles_per_refine: int = 3  # not tuned on the GPU
    # 'auto' (color-packed pipeline — production default) |
    # 'packed' | 'masked' | 'chebyshev' | 'strided'
    smoother: str = "auto"
    packed_min_side: int | None = None  # None -> structured.PACKED_MIN_SIDE


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Distribution knobs (amg_jax/parallel/structured_dist.py,
    parallel/ell_dist.py)."""

    n_devices: int | None = None   # default: all local devices
    axis_name: str = "x"
    min_rows_per_device: int = 2   # agglomeration threshold
    # structured path: None (auto by capability — 'overlap' on an
    # accelerator mesh, 'step' on a CPU mesh) |
    # 'overlap' | 'sweep' | 'packed' | 'step'; ELL path accepts
    # 'step' | 'strips' (others fall back to its default). Consumed via
    # the solvers' config= argument.
    halo: str | None = None
    # f32 V-cycles per df32 defect-correction step (honored by all three
    # solvers via the None-sentinel pattern; explicit constructor args
    # win over the config)
    cycles_per_refine: int | None = None
