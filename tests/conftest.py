import os

# Tests see the real single CPU device (the dry-run owns its own process).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_threefry_partitionable", True)


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="run tests marked slow (full benchmark grids)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: full benchmark grids, excluded from tier-1 runs")
    config.addinivalue_line(
        "markers", "requires_cuda: needs an NVIDIA GPU; skipped without one")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow benchmark: pass --runslow to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
