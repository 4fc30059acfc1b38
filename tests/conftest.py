"""Test configuration.

Numeric tests run on whatever backend is default (`JAX_PLATFORMS=cpu` for
the CPU tier).  Sharding tests need a multi-device mesh, so we always
expose 8 virtual CPU devices via XLA_FLAGS — access them with
`jax.devices("cpu")` regardless of the default backend.  Tests that need
the card are marked `gpu` and take the `gpu_device` fixture.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def cpu_mesh_devices():
    """8 virtual CPU devices for jax.sharding.Mesh tests."""
    import jax
    devs = jax.devices("cpu")
    assert len(devs) >= 8, "conftest expected 8 virtual CPU devices"
    return devs[:8]


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none.  Decided
    here, at run time, so every pytest-xdist worker collects the same
    tests."""
    import jax
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (JAX found none)")
    return gpus[0]
