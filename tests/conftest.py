"""Shared pytest config.

Marker registration + the `-m "not slow"` default live in pyproject.toml;
registering the marker here as well keeps collection warning-free when the
suite is invoked from a different rootdir (e.g. `pytest tests/ -c /dev/null`
in minimal CI containers).
"""
from __future__ import annotations

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-minute multi-device/e2e tests, deselected by default")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the PyTorch port's kernels); skips without one")


@pytest.fixture()
def clear_dse_caches():
    """Start the test from cold DSE caches and leave them cold afterwards."""
    from repro.core import cache

    cache.clear_all_caches()
    yield
    cache.clear_all_caches()
