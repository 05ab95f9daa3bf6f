"""Time converge samples of the path tracer on the card: sibenik 1920x1080,
32 bounces, NEE, guiding training, with the engine's default bands and spp.

    python tools/sample_bench.py [--samples 6] [--profile DIR] [--repo PATH]

--repo renders with the package of another checkout, so that two trees can
be compared in one call. Prints one JSON line: ms per converge sample
(median of the samples after the first, which compiles), Mrays/s, energy,
bands, spp, and the card's name and power limit. --profile traces one more
sample and adds its device ms by kernel category and its largest kernels.
Fails without a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIBENIK_VIEW = ([0.0, 5.0, -16.0], [0.0, 0.0, 1.0], 1.5, 12.0, 0.0)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--samples', type=int, default=6)
    p.add_argument('--profile', default='')
    p.add_argument('--repo', default=HERE)
    p.add_argument('--label', default='')
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.repo))

    import jax
    import numpy as np
    if jax.devices()[0].platform != 'gpu':
        raise SystemExit('sample_bench needs a GPU')
    from cuda_pathtracer_tpu.scene.builder import get_scene
    from cuda_pathtracer_tpu.models.pathtracer import Pathtracer
    from cuda_pathtracer_tpu.core.camera import Camera

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    cam = Camera.create(*SIBENIK_VIEW)
    t0 = time.perf_counter()
    pt = Pathtracer(get_scene('sibenik'), 1920, 1080)
    setup_s = time.perf_counter() - t0
    pt.render(cam, should_clear=True)
    pt.finish()
    times, rays = [], []
    for _ in range(args.samples):
        r0 = float(pt.rays_traced)
        t0 = time.perf_counter()
        pt.render(cam, should_clear=False)
        r1 = float(pt.rays_traced)          # waits for the sample
        times.append(time.perf_counter() - t0)
        rays.append(r1 - r0)
    total, has_nan, has_neg = pt.energy()
    out = {
        'label': args.label, 'repo': os.path.abspath(args.repo),
        'bands': pt.bands, 'spp': pt.spp,
        'ms_per_sample': float(np.median(times[1:]) * 1e3),
        'ms_per_sample_all': [t * 1e3 for t in times],
        'mrays_per_s': float(sum(rays[1:]) / sum(times[1:]) / 1e6),
        'first_sample_s': times[0], 'setup_s': setup_s,
        'energy': total, 'nan': has_nan, 'neg': has_neg, 'card': card}
    if args.profile:
        from cuda_pathtracer_tpu.utils.profiling import device_op_shares

        def one():
            pt.render(cam, should_clear=False)
            pt.finish()
        cats = device_op_shares(one, args.profile)
        out['profile_top_ops_ms'] = [(n[:60], ms)
                                     for n, ms in cats.pop('_top_ops')]
        out['profile_ms_by_category'] = cats
        out['profile_device_ms'] = sum(cats.values())
    print(json.dumps(out), flush=True)
    if has_nan or has_neg or not np.isfinite(total):
        raise SystemExit('energy audit failed')


if __name__ == '__main__':
    main()
