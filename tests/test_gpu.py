"""Card-only checks: the CUDA traversal kernel against the XLA reference at
real widths, id decoding after gathers, and f32 einsum precision.

Marked `gpu`; each test skips unless a CUDA device is present. On a machine
with a card: `JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu

W, H = 1920, 1080


@pytest.fixture(scope='module')
def gpu():
    try:
        devices = jax.devices('gpu')
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip('needs a CUDA device')
    return devices[0]


@pytest.fixture(scope='module')
def sibenik(gpu):
    from cuda_pathtracer_tpu.scene.builder import get_scene
    from cuda_pathtracer_tpu.core.camera import Camera
    from cuda_pathtracer_tpu.utils.wavefronts import wavefronts
    scene = get_scene('sibenik')
    arrays = jax.device_put(scene.to_device(), gpu)
    dyn = jax.device_put(scene.dynamic_arrays(), gpu)
    camera = Camera.create([0.0, 5.0, -16.0], [0.0, 0.0, 1.0], 1.5, 12.0, 0.0)
    return arrays, dyn, wavefronts(arrays, dyn, camera, W, H)


@pytest.mark.parametrize('kind', ['primary', 'bounce', 'shadow'])
def test_kernel_matches_reference(sibenik, kind):
    """Closest-hit prim_id on >= 99.99% of rays, |dt|/t <= 1e-5 where both
    pick the same primitive; any-hit occlusion on >= 99.99% of rays."""
    from cuda_pathtracer_tpu.ops.traverse import traverse
    from cuda_pathtracer_tpu.ops.traverse_cuda import (load_library,
                                                       traverse_cuda)
    arrays, dyn, waves = sibenik
    ro, rd, t_max, active = waves[kind]
    any_hit = kind == 'shadow'
    load_library()

    def run(fn, tables):
        return jax.jit(lambda *a: fn(*a[:4], t_max=a[4], active=a[5],
                                     any_hit=any_hit))(
            arrays, tables, ro, rd, t_max, active)

    got, want = run(traverse_cuda, dyn.kernel), run(traverse, dyn.world)
    n = ro.shape[0]
    assert n == W * H
    if any_hit:
        differ = int(jnp.sum(got.intersected != want.intersected))
        print(f'{kind}: {differ} of {n} rays disagree on occlusion')
        assert differ <= 1e-4 * n
        return
    gi, wi = np.asarray(got.intersected), np.asarray(want.intersected)
    gp, wp = np.asarray(got.prim_id), np.asarray(want.prim_id)
    gt, wt = np.asarray(got.t), np.asarray(want.t)
    same = (gi == wi) & (~wi | (gp == wp))
    print(f'{kind}: {int((~same).sum())} of {n} rays pick another primitive')
    assert (~same).sum() <= 1e-4 * n
    both = same & wi
    rel = np.abs(gt[both] - wt[both]) / np.maximum(np.abs(wt[both]), 1e-30)
    assert rel.max() <= 1e-5
    # barycentrics agree with the re-intersection the XLA path uses
    from cuda_pathtracer_tpu.ops import intersect as isect
    tri = np.asarray(dyn.world.tris)[np.maximum(gp, 0)]
    _, _, u, v = isect.ray_triangle(ro, rd, jnp.asarray(tri[:, 0:3]),
                                    jnp.asarray(tri[:, 3:6]),
                                    jnp.asarray(tri[:, 6:9]))
    tri_hit = both & (np.asarray(got.prim_type) == 0)
    np.testing.assert_allclose(np.asarray(got.u)[tri_hit],
                               np.asarray(u)[tri_hit], atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.v)[tri_hit],
                               np.asarray(v)[tri_hit], atol=1e-4)


def test_engine_trace_uses_kernel(sibenik):
    """dispatch.trace lowers to the FFI kernel on the card."""
    from cuda_pathtracer_tpu.ops.dispatch import trace
    arrays, dyn, waves = sibenik
    ro, rd, _, _ = waves['primary']
    text = jax.jit(trace).lower(arrays, dyn, ro[:4096], rd[:4096]).as_text()
    assert 'cpt_traverse' in text


def test_ids_decode_exactly(sibenik):
    """Material, texture and instance ids ride in f32 columns as int32 bit
    patterns (small ids are denormals); gathers and selects on the card must
    keep every bit."""
    from cuda_pathtracer_tpu.ops.lookup import table_lookup
    arrays, dyn, _ = sibenik
    n_tri = int(arrays.tri_packed.shape[0])
    n_inst = int(dyn.inst_packed.shape[0])
    rng = np.random.default_rng(0)
    gid = jnp.asarray(rng.integers(0, n_tri, 1 << 20), jnp.int32)
    inst = jnp.asarray(rng.integers(0, n_inst, 1 << 20), jnp.int32)
    cache = jnp.full((n_tri, 8), 0.1, jnp.float32)

    @jax.jit
    def decode(arrays, dyn, cache, gid, inst):
        bits = jax.lax.bitcast_convert_type
        row = jnp.concatenate([arrays.tri_packed, cache], axis=1)[gid]
        mid = bits(row[:, 15], jnp.int32)
        matp = table_lookup(arrays.mat_packed, mid)
        instp = table_lookup(dyn.inst_packed, inst)
        meta = dyn.tri_meta[gid % dyn.tri_meta.shape[0]]
        return (mid, bits(matp[:, 16], jnp.int32), bits(matp[:, 17], jnp.int32),
                bits(instp[:, 12], jnp.int32), bits(meta[:, 26], jnp.int32))

    mid, tex, ntex, override, meta_mid = (np.asarray(x) for x in
                                          decode(arrays, dyn, cache, gid,
                                                 inst))
    tri_mat = np.asarray(arrays.tri_mat)
    g = np.asarray(gid)
    np.testing.assert_array_equal(mid, tri_mat[g])
    np.testing.assert_array_equal(tex, np.asarray(arrays.mat_tex)[mid])
    np.testing.assert_array_equal(ntex, np.asarray(arrays.mat_normal_tex)[mid])
    np.testing.assert_array_equal(override, np.asarray(dyn.inst_mat)[inst])
    wt_gid = np.asarray(dyn.tri_meta[:, 0]).astype(np.int64)
    np.testing.assert_array_equal(
        meta_mid, tri_mat[wt_gid[g % len(wt_gid)]])


def test_einsums_full_f32(gpu):
    """Refit and transform einsums agree with numpy f64 to 1e-6 relative (a
    TF32 product would be off by ~1e-3)."""
    from cuda_pathtracer_tpu.accel import refit
    from cuda_pathtracer_tpu.core import vecmath as vm
    rng = np.random.default_rng(1)
    n = 1 << 16
    q = np.linalg.qr(rng.normal(size=(4, 3, 3)))[0]
    tf = np.concatenate([q * rng.uniform(0.5, 3.0, (4, 1, 1)),
                         rng.uniform(-20, 20, (4, 3, 1))], axis=2)
    tf_id = np.concatenate([tf, np.eye(3, 4)[None]], axis=0)
    inst = rng.integers(-1, 4, n)
    lo = rng.uniform(-10, 10, (n, 3))
    box = np.concatenate([lo, lo + rng.uniform(0.1, 5, (n, 3))], axis=1)
    tris = rng.uniform(-10, 10, (n, 9))
    with jax.default_device(gpu):
        nb, wt = refit._refit_world(
            jnp.asarray(box, jnp.float32), jnp.asarray(inst, jnp.int32),
            jnp.asarray(tris, jnp.float32), jnp.asarray(inst, jnp.int32),
            jnp.asarray(tf_id, jnp.float32),
            jnp.asarray([-1e3] * 3 + [1e3] * 3, jnp.float32))
        pts = jax.jit(vm.transform_point)(
            jnp.asarray(tf_id[np.where(inst < 0, 4, inst)], jnp.float32),
            jnp.asarray(tris[:, 0:3], jnp.float32))
    m = tf_id[np.where(inst < 0, 4, inst)]
    box32 = box.astype(np.float32).astype(np.float64)
    tris32 = tris.astype(np.float32).astype(np.float64)
    want_tris = (np.einsum('rij,rvj->rvi', m[:, :, :3], tris32.reshape(-1, 3, 3))
                 + m[:, None, :, 3]).reshape(-1, 9)
    scale = np.abs(want_tris).max()
    assert np.abs(np.asarray(wt) - want_tris).max() <= 1e-6 * scale
    np.testing.assert_allclose(np.asarray(pts), want_tris[:, 0:3],
                               atol=1e-6 * scale)
    corners = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1]), -1).reshape(-1, 3)
    c = box32[:, None, 0:3] * (1 - corners) + box32[:, None, 3:6] * corners
    wc = np.einsum('rij,rgj->rgi', m[:, :, :3], c) + m[:, None, :, 3]
    want_box = np.concatenate([wc.min(1), wc.max(1)], axis=1)
    want_box[inst < 0] = [-1e3] * 3 + [1e3] * 3
    assert np.abs(np.asarray(nb) - want_box).max() <= 1e-6 * scale
