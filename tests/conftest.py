"""Test configuration: CPU backend with 8 virtual devices, f64 numerics.

The reference's tolerances are all 1e-9-scale in double (SURVEY.md §7), so
tests run in f64. Multi-device sharding tests use the virtual-device CPU
mesh (the multi-host testing pattern the reference lacks; SURVEY.md §4).
The GPU is reached through chip_smoke.py, not through pytest.
"""

import os

# Force CPU even where JAX_PLATFORMS names an accelerator.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_enable_x64", True)
