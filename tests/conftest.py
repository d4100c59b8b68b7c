"""Test configuration: pick the JAX platform before jax initializes.

The platform is whatever ``JAX_PLATFORMS`` names, ``cpu`` when it is unset;
the CPU backend gets 8 virtual devices for the mesh tests.  Tests marked
``gpu`` need an NVIDIA GPU and skip elsewhere; run them on one with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -q
"""

import os

os.environ.setdefault(
    "XLA_FLAGS",
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8",
)

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips on other platforms)"
    )


@pytest.fixture
def gpu():
    """The first device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; the first device is {dev.platform}")
    return dev


@pytest.fixture
def rng():
    return np.random.RandomState(42)
