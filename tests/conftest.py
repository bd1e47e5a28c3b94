"""Test harness configuration.

Tests run on the CPU with 8 virtual devices (the standard JAX analog of
testing a device mesh without one — SURVEY.md section 4): deterministic,
fast, and exercises the same sharding code paths as real devices.

Tests that need an NVIDIA GPU carry the `gpu` marker and skip elsewhere;
on a card they run with `JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`,
and `chip_smoke.py` makes the same checks at full size.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# CPU unless the caller names platforms (JAX_PLATFORMS=cuda,cpu runs the
# `gpu`-marked tests on a card).
if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")


import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere; on a card: "
        "JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu)")


@pytest.fixture
def gpu_device():
    """Skip unless JAX can see a GPU (decided at run time, per test)."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU")
    return devs[0]
