"""spp-batched wavefront (render_sample spp>1) correctness.

One dispatch rendering k samples in a k*B-lane wavefront must agree with k
sequential 1-sample dispatches: same sample accounting, decorrelated RNG
streams per sample (disjoint rand_idx windows), and statistically the same
image. Reference semantics: the sample loop of Pathtracer::Render
(src/pathtracer.h:255-301) — batching is a device-side scheduling choice,
not a semantic one.
"""
import numpy as np
import pytest

from cuda_pathtracer_tpu.models.pathtracer import Pathtracer

from test_render import small_scene, cam, W, H


@pytest.fixture(scope='module')
def pair(reference_assets):
    scene = small_scene(reference_assets)
    seq = Pathtracer(scene, W, H, spp=1)
    bat = Pathtracer(scene, W, H, spp=4)
    for pt in (seq, bat):
        pt.render(cam(), should_clear=True)
    # 8 converge samples each: 8 calls sequential, 2 calls batched
    for _ in range(8):
        seq.render(cam(), should_clear=False)
    for _ in range(2):
        bat.render(cam(), should_clear=False)
    seq.finish()
    bat.finish()
    return seq, bat


def test_sample_accounting(pair):
    seq, bat = pair
    assert seq.sample_idx == bat.sample_idx == 2 + 8
    ws = np.asarray(seq.lum[:, 3])
    wb = np.asarray(bat.lum[:, 3])
    np.testing.assert_array_equal(ws, wb)   # same per-pixel sample counts


def test_batched_matches_sequential_statistically(pair):
    seq, bat = pair
    ls, _ = seq.accumulators_pixel_order()
    lb, _ = bat.accumulators_pixel_order()
    ls, lb = np.asarray(ls), np.asarray(lb)
    assert np.isfinite(lb).all()
    assert (lb[:, :3] >= 0).all()
    # independent MC estimates of the same integral: whole-image mean energy
    # agrees within a few percent at 10 samples
    ms, mb = ls[:, :3].mean(), lb[:, :3].mean()
    assert ms > 0 and mb > 0
    assert abs(ms - mb) / ms < 0.12, (ms, mb)


def test_batched_samples_are_decorrelated(pair):
    _, bat = pair
    # if the per-sample rand_idx windows collided, every sample would trace
    # identical rays and the accumulated variance would collapse to the
    # 2-sample interactive image's structure; spot-check that per-pixel
    # values are not k * any single sample (impossible to hit by chance)
    lb = np.asarray(bat.lum[:, :3])
    # at least some pixels saw light from several distinct samples: the
    # fractional parts of lum/first-sample ratios must vary
    nz = lb[lb[:, 0] > 1e-6, 0]
    assert np.unique(np.round(nz, 6)).size > nz.size // 4


def test_batched_guiding_ema_per_sample(reference_assets):
    """The nonlinear guiding EMA must run ONCE PER SAMPLE even in a batched
    dispatch (pathtracer.h:292-296). Lock: the inline spp=2 update equals
    sequentially propagating the SAME dispatch's per-sample deferred sums —
    bitwise. (Before round 4 the batched path applied the EMA once per
    DISPATCH over combined sums, which diverges multiplicatively.)"""
    import jax.numpy as jnp
    from cuda_pathtracer_tpu.models.pathtracer import render_sample
    from cuda_pathtracer_tpu.models import film
    from cuda_pathtracer_tpu.models.guiding import (init_radiance_state,
                                                    propagate)
    scene = small_scene(reference_assets)
    arrays, dyn = scene.to_device(), scene.dynamic_arrays()
    r0 = init_radiance_state(int(arrays.tri_mat.shape[0]))
    lum, alb = film.clear_accumulators(W * H)
    kw = dict(nee=True, cache_on=True, max_bounces=4,
              width=W, height=H, spp=2)
    _, _, (gsum, gcnt), _, _ = render_sample(
        arrays, dyn, cam(), r0, lum, alb, jnp.uint32(2), jnp.uint32(9),
        jnp.asarray(True), defer_guide=True, **kw)
    assert gsum.shape[0] == 2          # per-sample sums, not combined
    expect = propagate(propagate(r0, gsum[0], gcnt[0], jnp.asarray(True)),
                       gsum[1], gcnt[1], jnp.asarray(True))
    _, _, r2, _, _ = render_sample(
        arrays, dyn, cam(), r0, lum, alb, jnp.uint32(2), jnp.uint32(9),
        jnp.asarray(True), defer_guide=False, **kw)
    got, want = np.asarray(r2.cache), np.asarray(expect.cache)
    assert (got != want.min()).any()   # guiding actually trained
    # the inline and deferred paths fuse the bucket sums differently
    # (ulp-level association); anything beyond that is a wiring bug
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
