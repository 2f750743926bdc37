"""Test configuration: the CPU backend with 8 virtual devices.

Tests are fast and hermetic on the CPU. Multi-device sharding paths run
on a virtual 8-device CPU mesh. Speed is measured on the GPU by
bench.py and chip_smoke.py, not by pytest. Tests that need the card
carry the `gpu` marker and skip elsewhere (see the `gpu` fixture); on a
GPU machine they run with
`JAX_PLATFORMS=cuda python -m pytest -m gpu -p no:xdist tests/`.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import pytest  # noqa: E402

# Persistent compilation cache: CPU compiles of the whole-frame sweep
# dominate suite wall time; with the cache only the first run pays them.
from hagrid.utils import cache  # noqa: E402

cache.enable()


@pytest.fixture
def gpu():
    """The GPU devices, or a skip: decided when a test runs, never at
    import (every xdist worker must collect the same tests)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a GPU (JAX has {devs[0].platform})")
    return devs
