"""Auxiliary subsystems: checkpoint/resume, profiling, display, sky CDF."""
import os

import numpy as np
import pytest
import jax.numpy as jnp

from cuda_pathtracer_tpu.scene import procedural
from cuda_pathtracer_tpu.scene.scene import Scene, Material, GameObject, Plane
from cuda_pathtracer_tpu.models.pathtracer import Pathtracer
from cuda_pathtracer_tpu.models import sky as sky_mod
from cuda_pathtracer_tpu.core import camera as cam_mod
from cuda_pathtracer_tpu.utils.checkpoint import save_checkpoint, load_checkpoint
from cuda_pathtracer_tpu.utils.profiling import StageTimer, FpsMeter

W, H = 48, 32


def tiny_scene():
    scene = Scene()
    white = scene.add_material(Material.DIFFUSE((0.4,) * 3))
    cube = procedural.add_cube(scene, white)
    scene.add_object(GameObject(cube))
    scene.add_plane(Plane((0, -1, 0), -3, white))
    scene.finalize()
    return scene


def cam():
    return cam_mod.Camera.create([0, 2, -6], [0, -0.1, 1], 1.5, 6, 0.0)


@pytest.mark.slow
def test_checkpoint_roundtrip(tmp_path):
    scene = tiny_scene()
    pt = Pathtracer(scene, W, H)
    pt.render(cam(), should_clear=True)
    for _ in range(3):
        pt.render(cam(), should_clear=False)
    pt.finish()
    path = os.path.join(tmp_path, 'ckpt.npz')
    save_checkpoint(path, pt, cam())

    pt2 = Pathtracer(scene, W, H)
    cam2 = load_checkpoint(path, pt2)
    assert pt2.sample_idx == pt.sample_idx
    np.testing.assert_allclose(np.asarray(pt2.lum), np.asarray(pt.lum))
    np.testing.assert_allclose(np.asarray(pt2.radiance.cache),
                               np.asarray(pt.radiance.cache))
    np.testing.assert_allclose(np.asarray(cam2.eye), np.asarray(cam().eye))

    # resumed render continues identically to an uninterrupted one
    pt.render(cam(), should_clear=False)
    pt2.render(cam2, should_clear=False)
    np.testing.assert_allclose(np.asarray(pt2.lum), np.asarray(pt.lum),
                               rtol=1e-6)


def test_checkpoint_rejects_mismatched_engine(tmp_path):
    scene = tiny_scene()
    pt = Pathtracer(scene, W, H)
    pt.render(cam(), should_clear=True)
    path = os.path.join(tmp_path, 'c.npz')
    save_checkpoint(path, pt, cam())
    other = Pathtracer(scene, W * 2, H)
    try:
        load_checkpoint(path, other)
        assert False, 'expected resolution mismatch'
    except AssertionError as e:
        assert 'resolution' in str(e)


def test_stage_timer_and_fps():
    st = StageTimer()
    with st.stage('work'):
        sum(range(1000))
    assert 'work' in st.report()
    meter = FpsMeter(report_every=2)
    assert meter.frame() is None
    assert meter.frame() is not None


def test_sky_uv_roundtrip():
    """uvToNormal(normalToUv(n)) == n (kernels.h:31-49)."""
    r = np.random.RandomState(0)
    n = r.randn(256, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    u, v = sky_mod.normal_to_uv(jnp.asarray(n))
    back = np.asarray(sky_mod.uv_to_normal(u, v))
    np.testing.assert_allclose(back, n, atol=1e-4)


def test_sky_cdf():
    img = np.zeros((4, 8, 3), np.float32)
    img[2, 3] = [10.0, 5.0, 1.0]  # one bright texel
    values, cum = sky_mod.build_sky_cdf(img)
    assert abs(cum[-1] - 1.0) < 1e-5
    # sampling r=0.5 must land on the bright texel
    u, v, idx = sky_mod.sample_sky_cdf(jnp.asarray(cum), (4, 8),
                                       jnp.asarray(0.5))
    assert int(idx) == 2 * 8 + 3


def test_http_display_roundtrip():
    import urllib.request
    from cuda_pathtracer_tpu.utils.display import HttpDisplay
    d = HttpDisplay(port=0)  # 0 -> ephemeral port
    port = d.server.server_address[1]
    frame = np.zeros((8, 8, 3), np.uint8)
    frame[:, :, 0] = 255
    d.present(frame)
    page = urllib.request.urlopen(f'http://127.0.0.1:{port}/').read()
    assert b'cuda_pathtracer_tpu' in page
    png = urllib.request.urlopen(f'http://127.0.0.1:{port}/frame.png').read()
    assert png[:4] == b'\x89PNG'
    urllib.request.urlopen(f'http://127.0.0.1:{port}/key?k=w').read()
    assert 'w' in d.poll_keys()
    assert d.poll_keys() == set()   # edge: drained
    d.close()


def test_profiler_raises_without_gpu_plane(tmp_path):
    """The device-time reduction reads GPU device planes only; a CPU trace
    has none, and that is an error rather than an empty breakdown."""
    import jax.numpy as jnp
    from cuda_pathtracer_tpu.utils import profiling

    def run():
        jnp.ones(8).block_until_ready()

    with pytest.raises(RuntimeError, match='no GPU device plane'):
        profiling.device_op_shares(run, str(tmp_path / 'trace'))


@pytest.mark.parametrize('name,category', [
    ('(anonymous namespace)::traverse_kernel(float4 const*, float4 const*)',
     'traversal-kernel'),
    ('input_scatter_fusion_2', 'scatter'),
    ('fusion_3002', 'fusion'),
    ('sort_14', 'sort'),
    ('MemcpyH2D', 'copy/layout'),
])
def test_profiler_categories(name, category):
    from cuda_pathtracer_tpu.utils.profiling import _categorize_op
    assert _categorize_op(name) == category
