"""Test configuration.  JAX runs on the CPU unless JAX_PLATFORMS says
otherwise; on the CPU it gets a virtual 8-device mesh so the sharding paths
run without accelerators.  Tests marked ``gpu`` need an NVIDIA GPU and skip
elsewhere; run them on one with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/ -p no:xdist
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu(request):
    """Skip unless JAX's default device is a GPU (decided at run time)."""
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")
