"""Test configuration: force CPU with 8 virtual devices so sharding tests
run without accelerator hardware (no test worker ever opens the GPU), enable
x64 so oracle comparisons can be tight, and switch the persistent compile
cache off so the suite writes no XLA:CPU executables into the checkout.

The ``gpu`` marker (pyproject.toml) is registered for tests that can only
run on the card; the GPU path itself is exercised by ``python chip_smoke.py``.
"""

import os

# Must be set before jax initializes a backend.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)

