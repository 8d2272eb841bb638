"""Test configuration: CPU backend with 8 virtual devices, float64 on.

Multi-device sharding is validated on a simulated CPU mesh
(xla_force_host_platform_device_count), the standard way to test
shard_map without several accelerators.  The suite runs on the CPU
(fast compiles, float64); the GPU sweep kernels are checked there in
interpret mode, and on the card by the tests marked ``gpu`` and by
chip_smoke.py.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import pytest

# The CPU unless the caller names another platform (the GPU-marked
# tests run on the card with JAX_PLATFORMS=cuda).
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip unless the default backend is a GPU (decided at run time,
    never at import, so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the compiled Triton kernels have no "
                    "CPU lowering")
