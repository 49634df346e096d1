"""Test bootstrap: an 8-device virtual CPU mesh unless told otherwise.

Multi-device logic is exercised on virtual CPU devices, and the Pallas
kernels run in interpret mode. Tests marked ``gpu`` need the card and
skip elsewhere; run them on a GPU machine with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os
import sys

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "--xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu():
    """Skips the test unless JAX's first device is a GPU."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {platform!r})")
    return jax.devices()[0]
