"""Shared fixtures. NOTE: no XLA_FLAGS set here — unit/smoke tests run
against whatever the environment provides (1 real CPU device locally;
CI forces 8 fake host devices, which they must also tolerate).
Multi-device tests spawn subprocesses with their own
--xla_force_host_platform_device_count regardless (see
test_multidevice.py / test_comm.py).
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (CUDA kernels of repro_torch); "
        "skips, from inside the test, where there is none")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
