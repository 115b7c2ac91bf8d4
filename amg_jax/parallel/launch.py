"""Multi-host launch helpers.

On a real pod slice each host process calls ``initialize_distributed()``
before building solvers; the mesh then spans all hosts' devices and the
same ``shard_map`` programs run unchanged — halos that cross host
boundaries ride DCN instead of ICI, which the row-slab layout keeps to a
single W-row exchange per op (SURVEY.md §5 distributed-backend note).

Single-host simulation (what CI uses): set
``XLA_FLAGS=--xla_force_host_platform_device_count=N JAX_PLATFORMS=cpu``
before the first jax import — see tests/conftest.py.
"""

from __future__ import annotations

import jax


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None):
    """Initialize the multi-process JAX runtime (jax.distributed). With no
    arguments, environment-based auto-configuration is used (where the
    cluster environment provides it; on a plain GPU host pass all three
    arguments)."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)
    return dict(process_index=jax.process_index(),
                process_count=jax.process_count(),
                local_devices=len(jax.local_devices()),
                global_devices=len(jax.devices()))


def device_mesh_1d(n_devices: int | None = None, axis: str = "x"):
    """A 1-D mesh over the first n devices (all by default)."""
    if n_devices is None:
        n_devices = len(jax.devices())
    return jax.make_mesh((n_devices,), (axis,),
                         devices=jax.devices()[:n_devices])
