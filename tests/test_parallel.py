"""Multi-chip sharding on the virtual 8-device CPU mesh.

The sharded engine is the SAME engine (parallel/mesh.ShardedPathtracer
overrides only Pathtracer._sample_dispatch): every band runs the identical
tile-ordered / spp-batched / tail-narrowed render_sample. At matched band
geometry the sharded luminance is BIT-identical to single-chip; the guiding
cache differs only by partial-sum association (psum vs left-to-right band
sum).
"""
import jax
import numpy as np
import pytest

from cuda_pathtracer_tpu.parallel.mesh import make_mesh, ShardedPathtracer
from cuda_pathtracer_tpu.models.pathtracer import Pathtracer
from cuda_pathtracer_tpu.core import camera as cam_mod
from cuda_pathtracer_tpu.scene import procedural
from cuda_pathtracer_tpu.scene.scene import Scene, Material, GameObject, Plane

W, H = 64, 64


def scene_for():
    scene = Scene()
    white = scene.add_material(Material.DIFFUSE((0.4,) * 3))
    glow = Material.DIFFUSE((1, 1, 1))
    glow.emission = (8.0, 8.0, 8.0)
    glow_id = scene.add_material(glow)
    cube = procedural.add_cube(scene, white)
    scene.add_object(GameObject(cube))
    light = GameObject(cube, material_id=glow_id)
    light.position[:] = [0, 6, 0]
    scene.add_object(light)
    scene.add_plane(Plane((0, -1, 0), -3, white))
    scene.interactive_depth = 2
    scene.finalize()
    return scene


def cam():
    return cam_mod.Camera.create([0, 2, -6], [0, -0.1, 1], 1.5, 6, 0.0)


@pytest.mark.skipif(len(jax.devices()) < 8, reason='needs 8 virtual devices')
@pytest.mark.slow
def test_sharded_matches_single_chip_bitwise():
    scene = scene_for()

    mesh = make_mesh(jax.devices()[:8])
    sharded = ShardedPathtracer(scene, W, H, mesh=mesh)

    # force the single-chip engine onto the sharded engine's band geometry:
    # the per-band computation is then identical code with identical inputs
    single = Pathtracer(scene, W, H)
    single._set_bands(sharded.bands)
    assert (single.bands, single.band_h, single.tile_order) == \
        (sharded.bands, sharded.band_h, sharded.tile_order)
    # the sharded engine runs the TUNED configuration, not a bare fallback
    assert sharded.tile_order, 'sharded engine must keep tile-ordered lanes'

    # clear pass + first converge sample: the guiding cache is still in its
    # initial state on both engines, so the luminance must be BIT-identical
    for pt in (single, sharded):
        pt.render(cam(), should_clear=True)
        pt.render(cam(), should_clear=False)
        pt.finish()
    a = np.asarray(single.accumulators_pixel_order()[0])
    b = np.asarray(sharded.accumulators_pixel_order()[0])
    np.testing.assert_array_equal(a, b)   # BIT-identical luminance
    assert single.sample_idx == sharded.sample_idx
    assert int(single.rand_idx) == int(sharded.rand_idx)
    # the guiding cache is all-reduced; only the partial-sum association
    # differs (psum tree vs the band loop's left-to-right sum)
    np.testing.assert_allclose(np.asarray(single.radiance.cache),
                               np.asarray(sharded.radiance.cache),
                               rtol=1e-4, atol=1e-5)

    # further samples FEED BACK the cache (guided sampling reads it), so a
    # last-ulp cache difference may flip a CDF bucket for some lane: demand
    # statistical agreement, not bit equality
    for pt in (single, sharded):
        pt.render(cam(), should_clear=False)
        pt.finish()
    a = np.asarray(single.accumulators_pixel_order()[0])
    b = np.asarray(sharded.accumulators_pixel_order()[0])
    np.testing.assert_array_equal(a[:, 3], b[:, 3])
    ma, mb = a[:, :3].mean(), b[:, :3].mean()
    assert abs(ma - mb) / ma < 0.02, (ma, mb)


@pytest.mark.skipif(len(jax.devices()) < 2, reason='needs multiple devices')
def test_sharded_runs_on_two_devices():
    scene = scene_for()
    mesh = make_mesh(jax.devices()[:2])
    pt = ShardedPathtracer(scene, W, H, mesh=mesh)
    pt.render(cam(), should_clear=True)
    pt.finish()
    assert np.isfinite(np.asarray(pt.lum)).all()


@pytest.mark.skipif(len(jax.devices()) < 8, reason='needs 8 virtual devices')
@pytest.mark.slow
def test_sharded_awkward_height_pads():
    """A height with no mesh-aligned band count (H=100 on 8 devices) must
    render via internal padding, not assert — and the visible image must
    match a single-chip render at the REQUESTED resolution bit-for-bit."""
    scene = scene_for()
    H_odd = 100
    mesh = make_mesh(jax.devices()[:8])
    sharded = ShardedPathtracer(scene, W, H_odd, mesh=mesh)
    assert sharded.out_height == H_odd and sharded.height > H_odd
    assert sharded.height % 8 == 0

    single = Pathtracer(scene, W, H_odd)
    for pt in (single, sharded):
        pt.render(cam(), should_clear=True)
        pt.finish()

    # visible pixels identical: pad rows trace off-frustum rays below the
    # requested frame (full_height keys camera framing to H_odd), and the
    # crop removes them
    a = np.asarray(single.image())
    b = np.asarray(sharded.image())
    assert a.shape == b.shape == (H_odd, W, 3)
    np.testing.assert_array_equal(a, b)
    ea, eb = single.energy(), sharded.energy()
    assert not (ea[1] or eb[1])   # no NaNs either side


@pytest.mark.skipif(len(jax.devices()) < 8, reason='needs 8 virtual devices')
def test_sharded_spp_batching():
    """The sharded engine accepts the spp-batched configuration too (the
    whole tuned surface is shardable, not a reduced subset)."""
    scene = scene_for()
    mesh = make_mesh(jax.devices()[:8])
    pt = ShardedPathtracer(scene, W, H, mesh=mesh, spp=2)
    pt.render(cam(), should_clear=True)
    pt.render(cam(), should_clear=False)   # one dispatch, 2 samples
    pt.finish()
    assert pt.sample_idx == scene.interactive_depth + 2
    w = np.asarray(pt.lum[:, 3])
    assert (w == w[0]).all() and w[0] == pt.sample_idx
    assert np.isfinite(np.asarray(pt.lum)).all()


@pytest.mark.skipif(len(jax.devices()) < 4, reason='needs 4 virtual devices')
def test_sharded_converge_compiles_once():
    """The converge program compiles on the first sample only: the state a
    sample returns (mesh-sharded accumulators, replicated cache and rand
    counter) goes back in with the shardings it was compiled for."""
    scene = scene_for()
    pt = ShardedPathtracer(scene, 32, 16, mesh=make_mesh(jax.devices()[:4]))
    for _ in range(3):
        pt.render(cam(), should_clear=False)
    pt.finish()
    (run,) = pt._sharded_fns.values()
    assert run._cache_size() == 1
