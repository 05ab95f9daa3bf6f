"""Regenerate the per-config goldens (tests/test_goldens_configs.py) on the
CPU backend. Run after a DELIBERATE behavior change and note it in the commit
message:

    python tools/make_goldens.py ASSET_DIR

ASSET_DIR holds the reference assets the configs load (the directory the
tests' `reference_assets` fixture points at)."""
import os
import sys

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'tests'))

import conftest  # noqa: F401  (virtual CPU mesh, like the tests)
import numpy as np
from test_goldens_configs import render_config, CONFIGS, GOLDEN_DIR

for name in CONFIGS:
    data = render_config(name, sys.argv[1])
    out = os.path.join(GOLDEN_DIR, f'config_{name}.npz')
    np.savez_compressed(out, data=data)
    print(f'{name}: {data.shape} -> {out} (mean {data[..., :3].mean():.4f})')
