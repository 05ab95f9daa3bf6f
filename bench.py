"""Headline benchmark: Mrays/s on the sibenik-class scene at 1080p, on a GPU.

Prints ONE JSON line on stdout:
  {"metric": "Mrays/s sibenik-1080p", "value": N, "unit": "Mrays/s",
   "vs_baseline": N, "platform": ..., "device_kind": ..., "card": ...}

Baseline: the reference renders sibenik at 130 fps / 640x480 with 1 diffuse +
1 shadow ray on a GTX 960M (README.md:202) ≈ 80 Mrays/s; vs_baseline is
reported against that figure. Context lines (interactive frame, blur share,
device shares, other scenes) go to stderr. Fails without a GPU, and any
failing part fails the run.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

BASELINE_MRAYS = 80.0


def card_identity() -> str:
    """`name, power.limit` of the card as nvidia-smi reports them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()


def main():
    # two converge samples per dispatch (render_sample spp batching)
    os.environ.setdefault('CPT_SPP', '2')
    width, height = 1920, 1080
    bench_samples = int(os.environ.get('BENCH_SAMPLES', '8'))

    import jax
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        raise SystemExit(f'bench.py needs a GPU; JAX found {dev.platform}')
    card = card_identity()
    # both native libraries, built or loaded before timing; either raises
    # when it cannot be built
    from cuda_pathtracer_tpu.accel import native
    from cuda_pathtracer_tpu.ops import traverse_cuda
    bvh_builder = native.load()
    traverse_cuda.load_library()
    from cuda_pathtracer_tpu.scene.builder import get_scene
    from cuda_pathtracer_tpu.models.pathtracer import Pathtracer
    from cuda_pathtracer_tpu.core.camera import Camera

    scene = get_scene('sibenik')
    pt = Pathtracer(scene, width, height)
    # camera inside the hall looking down the nave
    camera = Camera.create([0.0, 5.0, -16.0], [0.0, 0.0, 1.0], 1.5, 12.0, 0.0)

    # compile + warm up (interactive clear then one converge sample)
    pt.render(camera, should_clear=True)
    pt.render(camera, should_clear=False)
    pt.finish()

    rays_before = float(pt.rays_traced)  # forces a full device sync
    t0 = time.perf_counter()
    for _ in range(bench_samples):
        pt.render(camera, should_clear=False)
    rays_after = float(pt.rays_traced)   # sync again: real wall time
    dt = time.perf_counter() - t0
    rays = rays_after - rays_before

    mrays = rays / dt / 1e6
    total, has_nan, has_neg = pt.energy()
    if has_nan or has_neg or not np.isfinite(total):
        raise SystemExit(f'energy audit failed: {total} nan={has_nan} '
                         f'neg={has_neg}')
    print(json.dumps({
        'metric': 'Mrays/s sibenik-1080p',
        'value': mrays,
        'unit': 'Mrays/s',
        'vs_baseline': mrays / BASELINE_MRAYS,
        'platform': dev.platform,
        'device_kind': dev.device_kind,
        'card': card,
        'bvh_builder': bvh_builder,
    }))
    print(f'# {rays/1e6:.1f} Mrays in {dt:.2f}s over {bench_samples} samples '
          f'({width}x{height}); energy={total:.1f}; {dev.device_kind}; '
          f'{card}', file=sys.stderr)

    # ---- interactive-rate figure (the reference headline: 130 fps at
    # 640x480 with 1 diffuse + 1 shadow ray, README.md:202) ----
    import jax.numpy as jnp
    from cuda_pathtracer_tpu.models.pathtracer import (render_sample,
                                                       tile_unpermute)
    from cuda_pathtracer_tpu.models import film
    from cuda_pathtracer_tpu.models.guiding import init_radiance_state
    iw, ih = 640, 480
    arrays, dyn = pt.arrays, pt.dyn
    radiance = init_radiance_state(int(arrays.tri_mat.shape[0]))
    lum, alb = film.clear_accumulators(iw * ih)

    # blue-noise values hoisted per lane like the engine's _bn_bands does
    bn_np = np.asarray(arrays.blue_noise)
    lanes = np.arange(iw * ih)
    tpr = iw // 16
    g, wl = lanes // 128, lanes % 128
    bn_lanes = jnp.asarray(bn_np[((g // tpr) * 8 + wl // 16) % bn_np.shape[0],
                                 ((g % tpr) * 16 + wl % 16) % bn_np.shape[1]])

    # parity config: the reference's 130 fps headline runs WITHOUT path
    # guiding (a compile-time flag, default off) — cache_on=False removes
    # the guided-CDF walk and guide_off the cache scatter
    def frame(i):
        return render_sample(arrays, dyn, camera, radiance, lum, alb,
                             jnp.uint32(0), jnp.uint32(i), jnp.asarray(False),
                             bn_lanes,
                             nee=True, cache_on=False, max_bounces=2,
                             width=iw, height=ih,
                             tile_order=True, guide_off=True)

    frame(0)[0].block_until_ready()
    frames = 30
    t0 = time.perf_counter()
    for i in range(frames):
        last = frame(i + 1)
    last[0].block_until_ready()
    fdt = time.perf_counter() - t0
    fps = frames / fdt
    irays = float(last[4]) * frames
    print(f'# interactive sibenik {iw}x{ih} (1 spp, depth 2, NEE): '
          f'{fps:.1f} fps wall-clock, {irays/fdt/1e6:.1f} Mrays/s '
          f'(reference: 130 fps on a GTX 960M)', file=sys.stderr)

    # device-side frame time: K whole interactive frames (clear + render +
    # display transform) in ONE jit, so host dispatch drops out
    K = 16

    @jax.jit
    def frames_device(rand0):
        def one(i, carry):
            rand_idx, _ = carry
            l0, a0 = film.clear_accumulators(iw * ih)
            l1, a1, _, ridx, _ = render_sample(
                arrays, dyn, camera, radiance, l0, a0,
                jnp.uint32(0), rand_idx, jnp.asarray(False), bn_lanes,
                nee=True, cache_on=False, max_bounces=2,
                width=iw, height=ih, tile_order=True,
                guide_off=True)
            l1 = tile_unpermute(l1, iw, ih)
            a1 = tile_unpermute(a1, iw, ih)
            img = film.display(l1, a1, 1.0, iw, ih, blur=False)
            return ridx, img
        return jax.lax.fori_loop(0, K, one, (rand0, jnp.zeros(
            (ih, iw, 3), jnp.float32)))

    frames_device(jnp.uint32(3))[1].block_until_ready()
    dev_dt = 1e9
    for t in range(3):
        t0 = time.perf_counter()
        frames_device(jnp.uint32(11 + t))[1].block_until_ready()
        dev_dt = min(dev_dt, (time.perf_counter() - t0) / K)
    print(f'# interactive_device_ms: {dev_dt*1e3:.2f} ms/frame = '
          f'{1.0/dev_dt:.1f} fps device-side (display transform fused)',
          file=sys.stderr)

    # ---- blur-filter share of frame time (reference: <=2%, README.md:173) --
    img_f = jax.jit(lambda l, a: film.display(l, a, 8.0, width, height,
                                              blur=False))
    img_b = jax.jit(lambda l, a: film.display(l, a, 8.0, width, height,
                                              blur=True))
    la, aa = pt.accumulators_pixel_order()
    la = jax.device_put(np.asarray(la))
    aa = jax.device_put(np.asarray(aa))
    img_f(la, aa).block_until_ready()
    img_b(la, aa).block_until_ready()
    t0 = time.perf_counter()
    for _ in range(10):
        r = img_f(la, aa)
    r.block_until_ready()
    t_plain = (time.perf_counter() - t0) / 10
    t0 = time.perf_counter()
    for _ in range(10):
        r = img_b(la, aa)
    r.block_until_ready()
    t_blur = (time.perf_counter() - t0) / 10
    print(f'# blur filter: {1e3*(t_blur-t_plain):.3f} ms/frame = '
          f'{100*(t_blur-t_plain)*fps:.2f}% of an interactive frame '
          f'(reference: <=2%)', file=sys.stderr)

    # ---- device time by kernel category over one converge sample ----
    if os.environ.get('BENCH_SHARES', '1') != '0':
        from cuda_pathtracer_tpu.utils import profiling as _prof

        def one_sample():
            pt.render(camera, should_clear=False)
            pt.finish()

        here = os.path.dirname(os.path.abspath(__file__))
        cats = _prof.device_op_shares(
            one_sample, os.path.join(here, 'chiprun_out', 'bench_trace'))
        top_ops = cats.pop('_top_ops')
        ctot = sum(cats.values()) or 1.0
        parts = '  '.join(
            f'{k} {v:.1f}ms ({100 * v / ctot:.1f}%)'
            for k, v in sorted(cats.items(), key=lambda kv: -kv[1]))
        print(f'# converge-sample device time: {parts}', file=sys.stderr)
        print('# top kernels: ' + '  '.join(
            f'{n[:48]} {ms:.1f}ms' for n, ms in top_ops[:8]),
            file=sys.stderr)

    # ---- per-scene rows: the whole surface, not one number ----
    if os.environ.get('BENCH_SCENES', '1') != '0':
        for row in bench_scenes():
            print('# ' + json.dumps(row), file=sys.stderr)


def bench_scenes():
    """Converge-rate rows for the other built-in scene families: the 2mtris
    stress scene and minecraft with guiding + blurred display."""
    from cuda_pathtracer_tpu.scene.builder import get_scene
    from cuda_pathtracer_tpu.models.pathtracer import Pathtracer
    from cuda_pathtracer_tpu.core.camera import Camera

    configs = [
        ('2mtris', '2mtris', 1920, 1080, 2,
         Camera.create([0, 6, -8], [0, -0.05, 1], 1.5, 8.0, 0.0), False),
        ('minecraft+guiding+blur', 'minecraft', 640, 480, 6,
         Camera.create([0, 6, -14], [0, -0.15, 1], 1.5, 10.0, 0.0), True),
    ]
    rows = []
    for label, name, w, h, samples, cam_, blur in configs:
        scene = get_scene(name)
        pt = Pathtracer(scene, w, h)
        pt.render(cam_, should_clear=True)
        pt.render(cam_, should_clear=False)   # warm the converge program
        pt.finish()
        r0 = float(pt.rays_traced)
        t0 = time.perf_counter()
        for _ in range(samples):
            pt.render(cam_, should_clear=False)
        r1 = float(pt.rays_traced)            # device sync
        dt = time.perf_counter() - t0
        img = np.asarray(pt.image(blur=blur))  # exercise the display path
        total, has_nan, _ = pt.energy()
        if has_nan or not np.isfinite(total) or not np.isfinite(img).all():
            raise SystemExit(f'{label}: non-finite render')
        rows.append({
            'metric': f'Mrays/s {label}',
            'value': (r1 - r0) / dt / 1e6,
            'unit': 'Mrays/s',
            'resolution': f'{w}x{h}',
            'samples': samples,
            'img_mean': float(img.mean()),
        })
    return rows


if __name__ == '__main__':
    main()
