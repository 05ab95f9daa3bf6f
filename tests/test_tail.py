"""Tail narrowing must be invisible in the rendered result: the compacted
continuation produces bit-identical output to the full-width loop when one
round suffices (pixel-seeded RNG makes both paths draw the same numbers)."""
import numpy as np
import jax.numpy as jnp
import pytest

import cuda_pathtracer_tpu.models.pathtracer as ptm
from cuda_pathtracer_tpu.models.pathtracer import Pathtracer
from cuda_pathtracer_tpu.scene.scene import Scene, Material, GameObject, Plane
from cuda_pathtracer_tpu.core import camera as cam_mod

W, H = 64, 48  # 3072 lanes


def scene_for(reference_assets):
    scene = Scene(asset_dirs=[reference_assets])
    white = scene.add_material(Material.DIFFUSE((0.7,) * 3))
    glow = Material.DIFFUSE((1, 1, 1))
    glow.emission = (8.0, 8.0, 8.0)
    gid = scene.add_material(glow)
    mirror = Material.DIFFUSE((0.9, 0.9, 0.9))
    mirror.reflect = 1.0
    mid = scene.add_material(mirror)
    cube = scene.add_model('cube.obj', 1.0, (0, 0, 0), (0, 0, 0), white)
    scene.add_object(GameObject(cube))
    m = GameObject(cube, material_id=mid)
    m.position[:] = [3, 0, 0]
    scene.add_object(m)
    light = GameObject(cube, material_id=gid)
    light.position[:] = [0, 6, 0]
    scene.add_object(light)
    scene.add_plane(Plane((0, -1, 0), -3, white))
    scene.interactive_depth = 2
    scene.finalize()
    return scene


def _render(reference_assets, samples=3):
    scene = scene_for(reference_assets)
    pt = Pathtracer(scene, W, H)
    cam = cam_mod.Camera.create([0, 2, -6], [0, -0.1, 1], 1.5, 6, 0.0)
    pt.render(cam, should_clear=True)
    for _ in range(samples):
        pt.render(cam, should_clear=False)
    pt.finish()
    return np.asarray(pt.lum), np.asarray(pt.alb)


@pytest.mark.slow
def test_tail_matches_full_width(reference_assets, monkeypatch):
    lum_full, alb_full = _render(reference_assets)
    # force the tail path on for this tiny frame. TAIL_DIV=1 keeps the
    # first-level buffer full-width so every pending lane fits one round —
    # the documented bit-identity regime (multi-round tails draw different
    # rand_idx values; unbiased but not bit-identical, see PARITY.md) —
    # while still exercising compaction, scatter-back and the cache carry.
    monkeypatch.setattr(ptm, 'TAIL_MIN_LANES', 1024)
    monkeypatch.setattr(ptm, 'TAIL_DIV', 1)
    ptm.render_sample.clear_cache()
    try:
        lum_tail, alb_tail = _render(reference_assets)
    finally:
        ptm.render_sample.clear_cache()
    np.testing.assert_allclose(lum_tail, lum_full, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(alb_tail, alb_full, rtol=1e-5, atol=1e-5)


def _guiding_scene(reference_assets):
    """Triangle-heavy scene where bounce-1+ hits land on OUTSIDE triangle
    faces (the only surfaces the guiding cache records, kernels.h:765):
    a big cube as the floor, a back wall, two cubes and an emissive cube.
    The checkerboard Plane would not do — plane hits never guide."""
    scene = Scene(asset_dirs=[reference_assets])
    white = scene.add_material(Material.DIFFUSE((0.8,) * 3))
    glow = Material.DIFFUSE((1, 1, 1))
    glow.emission = (6.0, 6.0, 6.0)
    gid = scene.add_material(glow)
    cube = scene.add_model('cube.obj', 1.0, (0, 0, 0), (0, 0, 0), white)
    floor = GameObject(cube)
    floor.scale = 14.0
    floor.position[:] = [0, -14.5, 0]
    scene.add_object(floor)
    wall = GameObject(cube)
    wall.scale = 6.0
    wall.position[:] = [0, 1.0, 12.0]
    scene.add_object(wall)
    c1 = GameObject(cube)
    c1.position[:] = [-1.5, 0, 2]
    scene.add_object(c1)
    c2 = GameObject(cube)
    c2.position[:] = [1.5, 0, 3]
    scene.add_object(c2)
    light = GameObject(cube, material_id=gid)
    light.position[:] = [0, 7, 2]
    scene.add_object(light)
    scene.finalize()
    return scene


def test_tail_multi_round_preserves_guiding(reference_assets, monkeypatch):
    """Multi-round tails pad later rounds' compaction buffers with lanes
    that already finished; their replayed bounces must NOT overwrite the
    guiding SampleCache records those lanes wrote in an earlier round
    (regression: pre-fix, the scatter-back replaced depth>=1 records of
    padded completed lanes with TERMINATE when TAIL_START <
    MAX_CACHE_DEPTH). RNG streams diverge between the configs, so the
    check is statistical: the guided-sample COUNT must stay comparable."""
    import jax.numpy as jnp
    from cuda_pathtracer_tpu.models.pathtracer import render_sample
    from cuda_pathtracer_tpu.models import film
    from cuda_pathtracer_tpu.models.guiding import init_radiance_state

    scene = _guiding_scene(reference_assets)
    arrays, dyn = scene.to_device(), scene.dynamic_arrays()
    radiance = init_radiance_state(int(arrays.tri_mat.shape[0]))
    lum, alb = film.clear_accumulators(W * H)
    cam = cam_mod.Camera.create([0, 2, -6], [0, -0.1, 1], 1.5, 6, 0.0)

    def guided_count():
        ptm.render_sample.clear_cache()
        _, _, (sums, counts), _, _ = render_sample(
            arrays, dyn, cam, radiance, lum, alb,
            jnp.uint32(1), jnp.uint32(5), jnp.asarray(True),
            nee=True, cache_on=True, max_bounces=8,
            width=W, height=H, defer_guide=True)
        return float(np.asarray(counts).sum())

    full = guided_count()                        # 3072 lanes < TAIL_MIN
    assert full > 100.0                          # the scene must guide

    monkeypatch.setattr(ptm, 'TAIL_MIN_LANES', 1024)
    monkeypatch.setattr(ptm, 'TAIL_START', 1)
    monkeypatch.setattr(ptm, 'TAIL_DIV', 8)      # C=384 << survivors
    try:
        tail = guided_count()
    finally:
        ptm.render_sample.clear_cache()
    # pre-fix this lost the depth>=1 records of every lane completed before
    # the level's final round (measured drop ~40%); post-fix the only
    # difference is RNG divergence in later rounds (a few percent)
    assert tail >= 0.75 * full, (tail, full)
