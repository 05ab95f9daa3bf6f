#!/usr/bin/env python3
"""Smoke test of the path tracer on NVIDIA GPUs: the main path once, through
the entry points a user calls, at the sizes users render.

    python chip_smoke.py            # one card, every phase below
    python chip_smoke.py --chips 4  # the sharded render over four cards
                                    # against one card, and nothing else

One card, in order:
  0. the card's name and power limit (nvidia-smi);
  1. the card-only tests (`pytest -m gpu`, a child process): the CUDA
     traversal kernel against ops/traverse.py on 1080p primary, bounce-1 and
     shadow wavefronts, id decoding, einsum precision;
  2. one headless CLI render (a child process);
  3. device check, and the builds of the kernel library and of the native
     BVH builder (set-up time; either raises when it cannot be built);
  4. sibenik 1920x1080: a clear frame and 4 converge samples (32 bounces,
     NEE, guiding training) with an energy audit; Mrays/s, ms/sample,
     compile time and peak device memory;
  5. the same scene at 480x270, 4 spp, on the CPU and on the GPU in this
     process: image mean and energy within 1%;
  6. the interactive frame (640x480, depth 2, NEE, no guiding): fps;
  7. 2mtris at 1080p, one converge sample, with the host BVH build time;
  8. minecraft 640x480 with guiding and the blurred display;
  9. one Whitted (--mode ray) frame.
The parent stays off JAX until its children have finished, so one process
holds the card at a time. Any failing phase raises; the exit code is then
non-zero and the result line is not printed. The last line of standard
output is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, 'chiprun_out')
# camera inside the cathedral looking down the nave (bench.py's view)
SIBENIK_VIEW = ([0.0, 5.0, -16.0], [0.0, 0.0, 1.0], 1.5, 12.0, 0.0)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_identity() -> str:
    """`name, power.limit` as nvidia-smi reports them; raises without one."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    if not out:
        raise RuntimeError('nvidia-smi lists no GPU')
    return out


def run_child(label: str, cmd: list[str], env: dict, timeout: int) -> None:
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                          text=True, timeout=timeout)
    tail = (proc.stdout + proc.stderr).strip().splitlines()[-20:]
    for line in tail:
        log(f'  | {line}')
    if proc.returncode != 0:
        raise RuntimeError(f'{label} exited with {proc.returncode}')
    log(f'{label}: ok in {time.perf_counter() - t0:.1f} s')


def camera():
    from cuda_pathtracer_tpu.core.camera import Camera
    return Camera.create(*SIBENIK_VIEW)


def check_energy(label: str, engine) -> float:
    import numpy as np
    total, has_nan, has_neg = engine.energy()
    if has_nan or has_neg or not np.isfinite(total) or total <= 0:
        raise RuntimeError(f'{label}: energy audit failed: {total} '
                           f'nan={has_nan} neg={has_neg}')
    return total


def converge(engine, cam, samples: int) -> None:
    while engine.sample_idx < samples:
        engine.render(cam, should_clear=False)


def phase_main_render(card: str, width: int = 1920, height: int = 1080):
    import jax
    from cuda_pathtracer_tpu.scene.builder import get_scene
    from cuda_pathtracer_tpu.models.pathtracer import Pathtracer
    cam = camera()
    t0 = time.perf_counter()
    scene = get_scene('sibenik')
    pt = Pathtracer(scene, width, height)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pt.render(cam, should_clear=True)
    pt.finish()
    clear_s = time.perf_counter() - t0
    times, rays = [], []
    for _ in range(4):
        r0 = float(pt.rays_traced)
        t0 = time.perf_counter()
        pt.render(cam, should_clear=False)
        r1 = float(pt.rays_traced)          # waits for the sample
        times.append(time.perf_counter() - t0)
        rays.append(r1 - r0)
    run_s = sum(times[1:]) / 3
    energy = check_energy('main render', pt)
    peak = (jax.devices()[0].memory_stats() or {}).get('peak_bytes_in_use')
    log(f'main render sibenik {width}x{height}, 4 converge samples '
        f'({pt.bands} bands): {sum(rays[1:]) / sum(times[1:]) / 1e6:.1f} '
        f'Mrays/s, {run_s * 1e3:.1f} ms/sample; compile ~'
        f'{times[0] - run_s:.1f} s (first sample {times[0]:.1f} s, clear '
        f'frame {clear_s:.1f} s, scene set-up {setup_s:.1f} s); energy '
        f'{energy:.1f}; peak_bytes_in_use {peak}; {card}')


def phase_gpu_vs_cpu(width: int = 480, height: int = 270, spp: int = 4):
    import jax
    import numpy as np
    from cuda_pathtracer_tpu.scene.builder import get_scene
    from cuda_pathtracer_tpu.models.pathtracer import Pathtracer
    cam = camera()
    results = {}
    for name, dev in (('gpu', jax.devices()[0]), ('cpu', jax.devices('cpu')[0])):
        t0 = time.perf_counter()
        with jax.default_device(dev):
            # a scene each: its device arrays are cached on the Scene
            pt = Pathtracer(get_scene('sibenik'), width, height)
            pt.render(cam, should_clear=True)
            converge(pt, cam, spp)
            img = np.asarray(pt.image())
            energy = check_energy(f'{name} render', pt)
        results[name] = (float(img.mean()), energy)
        log(f'  {name}: image mean {img.mean():.6f}, energy {energy:.3f} '
            f'({time.perf_counter() - t0:.1f} s)')
    (mg, eg), (mc, ec) = results['gpu'], results['cpu']
    dm, de = abs(mg - mc) / mc, abs(eg - ec) / ec
    log(f'GPU vs CPU sibenik {width}x{height} {spp} spp: image mean differs '
        f'by {dm:.3%}, energy by {de:.3%} (limit 1%)')
    if dm > 0.01 or de > 0.01:
        raise RuntimeError('GPU and CPU renders differ by more than 1%')


def phase_interactive(width: int = 640, height: int = 480):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from cuda_pathtracer_tpu.scene.builder import get_scene
    from cuda_pathtracer_tpu.models.pathtracer import Pathtracer
    from cuda_pathtracer_tpu.models.pathtracer import render_sample
    from cuda_pathtracer_tpu.models import film
    from cuda_pathtracer_tpu.utils.profiling import device_op_shares
    cam = camera()
    scene = get_scene('sibenik')
    pt = Pathtracer(scene, width, height)
    bn = pt._bn_bands()[0]
    lum, alb = film.clear_accumulators(width * height)

    # the reference's 130 fps configuration: depth 2, NEE, no guiding
    def frame(i):
        return render_sample(pt.arrays, pt.dyn, cam, pt.radiance, lum, alb,
                             jnp.uint32(0), jnp.uint32(i), jnp.asarray(False),
                             bn, nee=True, cache_on=False, max_bounces=2,
                             width=width, height=pt.band_h,
                             tile_order=pt.tile_order, guide_off=True)

    t0 = time.perf_counter()
    jax.block_until_ready(frame(0))
    compile_s = time.perf_counter() - t0
    n = 30
    t0 = time.perf_counter()
    for i in range(n):
        out = frame(i + 1)
    jax.block_until_ready(out)
    wall = (time.perf_counter() - t0) / n
    if not np.isfinite(np.asarray(out[0])).all():
        raise RuntimeError('interactive frame is not finite')

    def traced():
        for i in range(5):
            jax.block_until_ready(frame(100 + i))

    cats = device_op_shares(traced, os.path.join(OUT, 'trace_interactive'))
    top = cats.pop('_top_ops')
    device_ms = sum(cats.values()) / 5
    log(f'interactive sibenik {width}x{height} depth 2 NEE: {1 / wall:.1f} fps '
        f'({wall * 1e3:.2f} ms/frame wall-clock, {float(out[4]) / wall / 1e6:.1f}'
        f' Mrays/s; device {device_ms:.2f} ms/frame from the profiler, top '
        f'kernel {top[0][0][:40]} {top[0][1] / 5:.2f} ms; compile '
        f'{compile_s:.1f} s)')


def phase_large_mesh(width: int = 1920, height: int = 1080):
    from cuda_pathtracer_tpu.scene.builder import get_scene
    from cuda_pathtracer_tpu.models.pathtracer import Pathtracer
    from cuda_pathtracer_tpu.core.camera import Camera
    t0 = time.perf_counter()
    scene = get_scene('2mtris')
    scene.dynamic_arrays()
    build_s = time.perf_counter() - t0
    pt = Pathtracer(scene, width, height)
    cam = Camera.create([0, 6, -8], [0, -0.05, 1], 1.5, 8.0, 0.0)
    t0 = time.perf_counter()
    pt.render(cam, should_clear=False)
    pt.finish()
    energy = check_energy('2mtris', pt)
    log(f'2mtris {len(scene._v0)} triangles {width}x{height}: host BVH build '
        f'(native builder) {build_s:.1f} s, one converge sample '
        f'{time.perf_counter() - t0:.1f} s (with compile), energy {energy:.1f}')


def phase_guiding_blur(width: int = 640, height: int = 480):
    import numpy as np
    from cuda_pathtracer_tpu.scene.builder import get_scene
    from cuda_pathtracer_tpu.models.pathtracer import Pathtracer
    from cuda_pathtracer_tpu.core.camera import Camera
    scene = get_scene('minecraft')
    pt = Pathtracer(scene, width, height)
    cam = Camera.create([0, 6, -14], [0, -0.15, 1], 1.5, 10.0, 0.0)
    before = np.asarray(pt.radiance.cache)
    pt.render(cam, should_clear=True)
    converge(pt, cam, 3)
    changed = int((np.asarray(pt.radiance.cache) != before).sum())
    img = np.asarray(pt.image(blur=True))
    check_energy('minecraft', pt)
    if changed == 0 or not np.isfinite(img).all():
        raise RuntimeError(f'minecraft: cache entries changed {changed}, '
                           f'finite image {np.isfinite(img).all()}')
    log(f'minecraft {width}x{height} guiding + blur: {changed} radiance cache '
        f'entries trained, blurred image mean {img.mean():.4f}')


def phase_whitted(width: int = 640, height: int = 480):
    import numpy as np
    from cuda_pathtracer_tpu.scene.builder import get_scene
    from cuda_pathtracer_tpu.models.raytracer import Raytracer
    rt = Raytracer(get_scene('sibenik'), width, height)
    t0 = time.perf_counter()
    rt.render(camera(), should_clear=False)
    rt.finish()
    img = np.asarray(rt.image())
    if not np.isfinite(img).all() or img.mean() <= 0:
        raise RuntimeError('Whitted frame is empty or not finite')
    log(f'Whitted sibenik {width}x{height}: image mean {img.mean():.4f} '
        f'({time.perf_counter() - t0:.1f} s with compile)')


def phase_four_cards(card: str, width: int = 1920, height: int = 1080,
                     n_cards: int = 4, samples: int = 3):
    """ShardedPathtracer over n_cards against one card rendering the same
    band geometry: 3 converge samples each (guiding trains, so the later
    samples read a radiance cache summed by the NCCL psum). The first
    sample compiles; the steady-state time is the mean of the others."""
    import jax
    import numpy as np
    from cuda_pathtracer_tpu.scene.builder import get_scene
    from cuda_pathtracer_tpu.models.pathtracer import Pathtracer
    from cuda_pathtracer_tpu.parallel.mesh import ShardedPathtracer, make_mesh
    devices = jax.devices()
    if len(devices) != n_cards:
        raise RuntimeError(f'wanted {n_cards} devices, JAX has {len(devices)}')
    cam = camera()
    scene = get_scene('sibenik')
    sharded = ShardedPathtracer(scene, width, height,
                                mesh=make_mesh(devices))
    with jax.default_device(devices[0]):
        single = Pathtracer(scene, width, height)
    single._set_bands(sharded.bands)
    lums, steps = {}, {}
    for name, engine in (('sharded', sharded), ('single', single)):
        with jax.default_device(devices[0]):
            after = []
            for _ in range(samples):
                t0 = time.perf_counter()
                engine.render(cam, should_clear=False)
                engine.finish()
                steps.setdefault(name, []).append(time.perf_counter() - t0)
                after.append(np.asarray(engine.accumulators_pixel_order()[0]))
            check_energy(name, engine)
        lums[name] = after
    for name in ('sharded', 'single'):
        log(f'{name}: converge samples took '
            + ', '.join(f'{t * 1e3:.1f}' for t in steps[name]) + ' ms')
    four = sum(steps['sharded'][1:]) / (samples - 1)
    one = sum(steps['single'][1:]) / (samples - 1)
    log(f'per converge sample, steady state (samples 2-{samples}): '
        f'{n_cards} cards {four * 1e3:.1f} ms, 1 card {one * 1e3:.1f} ms, '
        f'speed-up {one / four:.2f}x ({sharded.bands} bands of '
        f'{sharded.band_h} rows); {card}')
    for k in range(samples):
        a, b = lums['sharded'][k], lums['single'][k]
        equal = bool((a == b).all())
        rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        log(f'after converge sample {k + 1}: sharded == single bitwise: '
            f'{equal} (max |diff| / max |lum| = {rel:.3g})')
        if k == 0 and not equal:
            raise RuntimeError('first converge sample: sharded render '
                               'differs from the single card')
        if rel > 1e-3:
            raise RuntimeError('sharded render differs from the single card')


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--chips', type=int, choices=(1, 4), default=1)
    args = parser.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, 'cuda_pathtracer_tpu')):
        log('chip_smoke.py must run from a checkout of the repository')
        return 2
    os.makedirs(OUT, exist_ok=True)

    card = card_identity()
    log(card)
    env = dict(os.environ, JAX_PLATFORMS='cuda,cpu')

    if args.chips == 1:
        run_child('card-only tests',
                  [sys.executable, '-m', 'pytest', 'tests', '-m', 'gpu',
                   '-q', '-s', '-p', 'no:cacheprovider'], env, 600)
        run_child('CLI render',
                  [sys.executable, '-m', 'cuda_pathtracer_tpu', '--scene',
                   'sibenik', '--spp', '2', '--out',
                   os.path.join(OUT, 'smoke_cli.png'),
                   '--state', os.path.join(OUT, 'smoke_save.txt')], env, 600)

    os.environ['JAX_PLATFORMS'] = 'cuda,cpu'
    import jax
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        raise RuntimeError(f'JAX found no GPU (platform {dev.platform})')
    sys.path.insert(0, HERE)
    from cuda_pathtracer_tpu.accel import native
    from cuda_pathtracer_tpu.ops import traverse_cuda
    t0 = time.perf_counter()
    traverse_cuda.load_library()
    t1 = time.perf_counter()
    bvh_builder = native.load()
    log(f'device {dev.platform} {dev.device_kind} x{len(jax.devices())}; '
        f'kernel library built/loaded in {t1 - t0:.1f} s; native BVH builder '
        f'{bvh_builder} built/loaded in {time.perf_counter() - t1:.1f} s')

    if args.chips == 4:
        phase_four_cards(card)
    else:
        for phase in (phase_main_render, phase_gpu_vs_cpu, phase_interactive,
                      phase_large_mesh, phase_guiding_blur, phase_whitted):
            t0 = time.perf_counter()
            phase(card) if phase is phase_main_render else phase()
            log(f'{phase.__name__}: ok in {time.perf_counter() - t0:.1f} s')

    print(json.dumps({'ok': True, 'device': {
        'platform': dev.platform, 'kind': dev.device_kind,
        'count': len(jax.devices())}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
