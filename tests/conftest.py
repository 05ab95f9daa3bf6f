"""Test configuration: the CPU with an 8-device virtual mesh unless the
caller names the platforms.

The tier-1 tests run on the CPU: JAX_PLATFORMS defaults to cpu and
xla_force_host_platform_device_count=8 gives the multi-device sharding paths
a virtual mesh (SURVEY.md §4's "fake backend"). Tests of code that runs only
on a card carry the `gpu` marker and skip without one; run them with the
platforms set, e.g. `JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu`.
"""
import os

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags + ' --xla_force_host_platform_device_count=8').strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# the reference repository's assets (teapot.obj, cube.obj, .chai scripts,
# goldens' inputs), when a copy is at hand
REFERENCE_DIR = os.environ.get('CPT_REFERENCE_ASSETS', '')


@pytest.fixture(scope='session')
def reference_assets():
    if not REFERENCE_DIR or not os.path.isdir(REFERENCE_DIR):
        pytest.skip('reference assets not available (CPT_REFERENCE_ASSETS)')
    return REFERENCE_DIR


@pytest.fixture(autouse=True)
def _seed_numpy():
    np.random.seed(0)
