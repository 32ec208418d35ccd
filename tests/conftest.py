"""Test configuration.

Tests run on a virtual 8-device CPU mesh (multi-device sharding is tested
without multi-card hardware), with the Pallas kernel in interpreter mode.

GPU lane: tests marked ``gpu`` (tests/test_on_chip.py) compile the kernels
for the card; each decides inside a fixture whether a GPU backend is
present and skips otherwise. On the machine with the card run

    CESCOIN_GPU_TESTS=1 python -m pytest -m gpu tests/test_on_chip.py

(chip_smoke.py runs the same lane). Without CESCOIN_GPU_TESTS=1 the
platform is pinned to the CPU.
"""

import os

GPU_LANE = os.environ.get("CESCOIN_GPU_TESTS", "") == "1"

# Read by the CPU client at first backend init (still lazy at this point).
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not GPU_LANE:
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
