"""Test configuration: the CPU backend with an 8-device virtual mesh.

Multi-device sharding is validated on virtual CPU devices. JAX_PLATFORMS
defaults to cpu here; tests marked `gpu` run on the card with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`` and skip elsewhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
