"""Test configuration.

Tests run on the CPU backend with 8 virtual devices so multi-device
sharding code paths (jax.sharding.Mesh over data/model axes) are
exercised without accelerators — mirroring the reference's strategy of
running "cluster" jobs locally via run.pl (SURVEY.md §4: distributed
testing without a cluster).  The card itself is exercised by
chip_smoke.py, not by this suite.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax
import numpy as np
import pytest

assert jax.devices()[0].platform == "cpu"
assert jax.device_count() == 8, "expected 8 virtual CPU devices for mesh tests"


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
