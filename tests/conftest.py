"""Test configuration: force an 8-device virtual CPU platform so multi-chip
sharding paths are exercised without TPU hardware (SURVEY.md §4e)."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"   # override any ambient TPU platform
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# Site customization may import jax before this conftest runs (pinning the
# ambient TPU platform); force the CPU platform through the config API too.
jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "multichip: exercises the multi-device sharded path")
    config.addinivalue_line("markers", "slow: heavy test (excluded from the smoke tier)")
    config.addinivalue_line("markers", "smoke: fast tier — `pytest -m smoke` runs in <2 min")
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels); skips elsewhere")


def pytest_collection_modifyitems(config, items):
    """Every test not marked slow belongs to the smoke tier, so
    `pytest -m smoke` gives a fast regression pass without per-test
    bookkeeping."""
    for item in items:
        if "slow" not in item.keywords:
            item.add_marker(pytest.mark.smoke)


@pytest.fixture(scope="session")
def synthetic_zip(tmp_path_factory):
    """Small synthetic swipelogs zip shared across the test session."""
    from wordgesture_gan_tpu.data.synthetic import write_synthetic_swipelogs_zip

    path = tmp_path_factory.mktemp("data") / "swipelogs.zip"
    write_synthetic_swipelogs_zip(str(path), n_users=6, seed=0, n_sentences=4,
                                  words_per_sentence=4, max_vocab=80)
    return str(path)
