"""Pytest setup: the suite runs on the CPU with 8 fake devices, so every
test (sharding and collective ones included) runs without an accelerator
(SURVEY.md section 4 item 4). Tests that need the GPU carry the ``gpu``
marker (pyproject.toml) and take the ``gpu_device`` fixture, which skips
them here; chip_smoke.py exercises that path on the card.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU (run chip_smoke.py on the card)")
    return gpus[0]


def pytest_sessionstart(session):
    devices = jax.devices()
    assert devices[0].platform == "cpu", f"tests must run on CPU: {devices}"
    assert len(devices) == 8, f"expected 8 fake devices: {devices}"
