"""End-to-end wavefront engine tests: energy, NEE, guiding, film."""
import numpy as np
import jax.numpy as jnp
import pytest

from cuda_pathtracer_tpu.scene.scene import (Scene, Material, GameObject,
                                             Plane)
from cuda_pathtracer_tpu.models.pathtracer import Pathtracer
from cuda_pathtracer_tpu.models import film, guiding
from cuda_pathtracer_tpu.core import camera as cam_mod

W, H = 64, 48


def small_scene(reference_assets, emissive=True):
    scene = Scene(asset_dirs=[reference_assets])
    white = scene.add_material(Material.DIFFUSE((0.4,) * 3))
    glow = Material.DIFFUSE((1, 1, 1))
    glow.emission = (10.0, 10.0, 10.0)
    glow_id = scene.add_material(glow)
    cube = scene.add_model('cube.obj', 1.0, (0, 0, 0), (0, 0, 0), white)
    scene.add_object(GameObject(cube))
    if emissive:
        light = GameObject(cube, material_id=glow_id)
        light.position[:] = [0, 6, 0]
        light.scale[:] = 0.5
        scene.add_object(light)
    scene.add_plane(Plane((0, -1, 0), -3, white))
    scene.interactive_depth = 2
    scene.finalize()
    return scene


def cam():
    return cam_mod.Camera.create([0, 2, -6], [0, -0.1, 1], 1.5, 6, 0.0)


@pytest.fixture(scope='module')
def rendered(reference_assets):
    scene = small_scene(reference_assets)
    pt = Pathtracer(scene, W, H)
    pt.render(cam(), should_clear=True)
    for _ in range(4):
        pt.render(cam(), should_clear=False)
    pt.finish()
    return pt


def test_render_finite_positive(rendered):
    total, has_nan, has_neg = rendered.energy()
    assert not has_nan
    assert not has_neg
    assert total > 0.0
    assert rendered.sample_idx == 2 + 4  # interactive_depth + 4 converge


def test_image_shapes_and_range(rendered):
    img = np.asarray(rendered.image(blur=False))
    assert img.shape == (H, W, 3)
    assert np.isfinite(img).all()
    assert img.min() >= 0.0
    imgb = np.asarray(rendered.image(blur=True))
    assert imgb.shape == (H, W, 3)
    assert np.isfinite(imgb).all()


def test_energy_stable_across_samples(reference_assets):
    """The DEBUG_ENERGY audit: per-sample energy should be roughly constant
    as samples accumulate (unbiasedness smoke check, main.cpp:342-366)."""
    scene = small_scene(reference_assets)
    pt = Pathtracer(scene, W, H)
    pt.render(cam(), should_clear=True)
    pt.render(cam(), should_clear=False)
    e1, _, _ = pt.energy()
    for _ in range(6):
        pt.render(cam(), should_clear=False)
    e2, _, _ = pt.energy()
    assert e2 > 0
    assert abs(e1 - e2) / e2 < 0.5  # noisy but same order


@pytest.mark.slow
def test_nee_toggle_converges_similarly(reference_assets):
    """NEE on/off must estimate the same integral (README.md:296-311 is the
    reference's visual A/B); statistically loose with few samples."""
    means = []
    for nee in (True, False):
        scene = small_scene(reference_assets)
        pt = Pathtracer(scene, W, H)
        pt.nee = nee
        pt.render(cam(), should_clear=True)
        for _ in range(30):
            pt.render(cam(), should_clear=False)
        img = np.asarray(pt.lum[:, :3]) / pt.sample_idx
        means.append(img.mean())
    assert means[0] > 0 and means[1] > 0
    assert abs(means[0] - means[1]) / max(means) < 0.35


def test_guiding_cache_updates(reference_assets):
    scene = small_scene(reference_assets)
    pt = Pathtracer(scene, W, H)
    pt.render(cam(), should_clear=True)
    before = np.asarray(pt.radiance.cache).copy()
    for _ in range(5):
        pt.render(cam(), should_clear=False)
    after = np.asarray(pt.radiance.cache)
    assert (after != before).any()          # learned something
    assert (after >= guiding.VALUE_MIN - 1e-6).all()
    assert (after <= guiding.VALUE_MAX + 1e-6).all()
    total = np.asarray(pt.radiance.total)
    np.testing.assert_allclose(total, after.sum(axis=1), rtol=1e-3)


def test_guiding_gated_off_in_interactive(reference_assets):
    scene = small_scene(reference_assets)
    pt = Pathtracer(scene, W, H)
    pt.render(cam(), should_clear=True)   # interactive: no guiding update
    after = np.asarray(pt.radiance.cache)
    np.testing.assert_allclose(after, np.float32(guiding.VALUE_MIN), rtol=0)


def test_blur_approaches_identity_at_high_sample_counts():
    """spread = max(0.7, n/200) grows with n, so the kernel sharpens toward a
    delta as the image converges (main.cpp:126,157)."""
    rng = np.random.RandomState(0)
    n = 4000.0
    lum_rgb = rng.rand(H * W, 3).astype(np.float32)
    lum = jnp.asarray(np.concatenate([lum_rgb * n, np.full((H * W, 1), n,
                                                           np.float32)], axis=1))
    alb = jnp.asarray(np.concatenate([np.ones((H * W, 3), np.float32) * n,
                                      np.full((H * W, 1), n, np.float32)], axis=1))
    blurred = np.asarray(film.blur_luminance(lum, alb, n, W, H)) / n
    np.testing.assert_allclose(blurred, lum_rgb, atol=1e-3)


def test_energy_audit_detects_nan():
    lum = jnp.asarray(np.array([[1.0, np.nan, 0.5, 2.0]], np.float32))
    _, has_nan, _ = film.energy_audit(lum)
    assert bool(has_nan)


def test_display_transform_gamma_vignette():
    """quad_fs semantics (main.cpp:46-72): color = sqrt(lum/w) * vignette."""
    W2, H2 = 8, 6
    lum = np.zeros((W2 * H2, 4), np.float32)
    lum[:, :3] = 0.25 * 4.0   # accumulated over 4 samples
    lum[:, 3] = 4.0
    alb = np.ones_like(lum)
    img = np.asarray(film.display(jnp.asarray(lum), jnp.asarray(alb), 4.0,
                                  W2, H2, blur=False))
    # center pixel: sqrt(0.25) * (1 - tiny center offset^2) ~ 0.5
    cy, cx = H2 // 2, W2 // 2
    assert abs(img[cy, cx, 0] - 0.5) < 0.01
    # corners darker than center (vignette)
    assert img[0, 0, 0] < img[cy, cx, 0]
    # vignette formula check at the corner pixel center
    u = (0 + 0.5) / W2 - 0.5
    v = (0 + 0.5) / H2 - 0.5
    np.testing.assert_allclose(img[0, 0, 0], 0.5 * (1 - (u * u + v * v)),
                               rtol=1e-5)


def test_table_lookup_exact():
    """Small-table lookup must be bit-exact vs gather (ops/lookup.py) —
    INCLUDING int32 ids bitcast into f32 lanes, which are denormals that any
    arithmetic lookup (one-hot matmul) could flush to zero on a device that
    flushes denormals."""
    import numpy as np
    import jax.numpy as jnp
    from cuda_pathtracer_tpu.ops.lookup import table_lookup
    rng = np.random.default_rng(3)
    tab = rng.standard_normal((13, 24)).astype(np.float32) * 1e3
    tab[:, 20:24] = rng.integers(0, 99, (13, 4)).astype(np.int32).view(np.float32)
    tabj = jnp.asarray(tab)
    idx = jnp.asarray(rng.integers(0, 13, size=1000).astype(np.int32))
    got = np.asarray(table_lookup(tabj, idx))
    want = tab[np.asarray(idx)]
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # clamp semantics match gather
    got2 = np.asarray(table_lookup(tabj, jnp.asarray([25, 12], jnp.int32)))
    np.testing.assert_array_equal(got2[0].view(np.int32),
                                  tab[12].view(np.int32))
