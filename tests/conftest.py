"""Test harness config.

IMPORTANT: no XLA_FLAGS / device-count overrides here — smoke tests and
benches must see the real single CPU device.  Multi-device sharding
tests spawn subprocesses with their own XLA_FLAGS (see
tests/test_dryrun.py).

Property-based tests go through ``tests/_pbt.py``, which re-exports
hypothesis when installed and a deterministic fixed-seed shim when not
— the tier-1 suite must collect and pass either way.
"""

import numpy as np
import pytest
from _pbt import settings

# Keep hypothesis deadlines off: jit compilation on first example would
# blow any wall-clock deadline and has nothing to do with correctness.
settings.register_profile("repro", deadline=None, max_examples=60, derandomize=True)
settings.load_profile("repro")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)  # the paper's seed


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (a CUDA kernel of the PyTorch port); skips without one",
    )
