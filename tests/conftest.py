"""Test harness: CPU backend with 8 virtual devices, float64 enabled.

The backend is chosen before the first ``import jax`` anywhere in the test
process (SURVEY.md §4: multi-host tests runnable on CPU via
``xla_force_host_platform_device_count``). With ``--gpu`` the tests run on
the machine's GPU instead, in float32; tests that need the card are marked
``gpu`` and skip elsewhere (``python -m pytest tests/ -m gpu --gpu``).
"""

import os
import sys

ON_GPU = "--gpu" in sys.argv
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked slow (long traverses, big equality sweeps)",
    )
    parser.addoption(
        "--gpu", action="store_true", default=False,
        help="run on the machine's GPU instead of the CPU (with -m gpu: "
             "the tests that need the card)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test, skipped unless --runslow is given "
        "(keeps the default `pytest tests/` lane under ~10 min)",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU (the compiled kernels); skips elsewhere. "
        "Run on the card with `python -m pytest tests/ -m gpu --gpu`",
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow — run with --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, at run time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `python -m pytest tests/ -m gpu --gpu` "
                    "on the card")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
