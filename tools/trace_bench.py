"""Time traversal per wavefront kind on the card: the CUDA kernel
(ops/traverse_cuda.py) against XLA's threaded walk (ops/traverse.py, the CPU
path and the reference).

    python tools/trace_bench.py [--scene sibenik] [--width 1920 --height 1080]
                                [--fmad] [--no-xla]

--fmad also builds the kernel with multiply-add contraction (FMAD=true into
ops/cuda/build/fmad) and times it beside the default -fmad=false build, in
the same process. Prints one JSON line per (kind, path) with the median ms of
--reps timed calls, the card's name and power limit beside them. Fails
without a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card_identity() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--scene', default='sibenik')
    p.add_argument('--width', type=int, default=1920)
    p.add_argument('--height', type=int, default=1080)
    p.add_argument('--reps', type=int, default=10)
    p.add_argument('--fmad', action='store_true')
    p.add_argument('--no-xla', action='store_true')
    args = p.parse_args(argv)

    import jax
    import numpy as np
    if jax.devices()[0].platform != 'gpu':
        raise SystemExit('trace_bench needs a GPU')
    from cuda_pathtracer_tpu.scene.builder import get_scene
    from cuda_pathtracer_tpu.core.camera import Camera
    from cuda_pathtracer_tpu.ops import traverse_cuda
    from cuda_pathtracer_tpu.ops.traverse import traverse
    from cuda_pathtracer_tpu.utils.wavefronts import wavefronts

    card = card_identity()
    scene = get_scene(args.scene)
    arrays, dyn = scene.to_device(), scene.dynamic_arrays()
    camera = Camera.create([0.0, 5.0, -16.0], [0.0, 0.0, 1.0], 1.5, 12.0, 0.0)
    waves = wavefronts(arrays, dyn, camera, args.width, args.height)
    traverse_cuda.load_library()

    def kernel(target):
        def fn(arrays, dyn, ro, rd, t_max, active, any_hit):
            return traverse_cuda.traverse_cuda(arrays, dyn.kernel, ro, rd,
                                               t_max, active, any_hit,
                                               target=target)
        return fn

    def xla(arrays, dyn, ro, rd, t_max, active, any_hit):
        return traverse(arrays, dyn.world, ro, rd, t_max, active, any_hit)

    paths = [('cuda', kernel(traverse_cuda.TARGET))]
    if args.fmad:
        fmad_dir = os.path.join(traverse_cuda.CUDA_DIR, 'build', 'fmad')
        traverse_cuda.register('cpt_traverse_fmad',
                               os.path.join(fmad_dir, 'libcpt_traverse.so'),
                               'FMAD=true', 'BUILD=build/fmad')
        paths.append(('cuda_fmad', kernel('cpt_traverse_fmad')))
    if not args.no_xla:
        paths.append(('xla_threaded', xla))

    for kind in ('primary', 'bounce', 'shadow'):
        ro, rd, t_max, active = waves[kind]
        any_hit = kind == 'shadow'
        ref = None
        for path, fn in paths:
            f = jax.jit(lambda *a, fn=fn: fn(*a).intersected,
                        static_argnums=6)
            t0 = time.perf_counter()
            hits = np.asarray(f(arrays, dyn, ro, rd, t_max, active, any_hit))
            compile_s = time.perf_counter() - t0
            times = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                jax.block_until_ready(
                    f(arrays, dyn, ro, rd, t_max, active, any_hit))
                times.append(time.perf_counter() - t0)
            if ref is None:
                ref = hits
            print(json.dumps({
                'kind': kind, 'path': path,
                'rays': int(ro.shape[0]),
                'active': int(np.asarray(active).sum()),
                'ms': float(np.median(times) * 1e3),
                'ms_min': float(np.min(times) * 1e3),
                'first_call_s': compile_s,
                'hit_fraction': float(hits.mean()),
                'hits_differ_from_first': int((hits != ref).sum()),
                'card': card}), flush=True)


if __name__ == '__main__':
    main()
