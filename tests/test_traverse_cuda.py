"""The GPU traversal wrapper (ops/traverse_cuda.py) and the platform choice
in ops/dispatch.py, on the CPU.

The CUDA kernel itself runs only on a card (tests/test_gpu.py). Here a
Python transcription of the kernel's walk checks the tables it reads, the
library call is replaced by the XLA reference walk to check the padding to
the block size and back, and the platform choice is checked by lowering for
each platform.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_pathtracer_tpu.accel.flatten import inner_ancestors
from cuda_pathtracer_tpu.ops import dispatch, intersect as isect
from cuda_pathtracer_tpu.ops import traverse_cuda
from cuda_pathtracer_tpu.ops.traverse import traverse
from cuda_pathtracer_tpu.scene import procedural
from cuda_pathtracer_tpu.scene.scene import (Scene, Material, GameObject,
                                             Sphere, Plane)


@pytest.fixture(scope='module')
def scene():
    s = Scene()
    m = s.add_material(Material.DIFFUSE((0.5,) * 3))
    cube = procedural.add_cube(s, m)
    v0, v1, v2 = procedural._displaced_sphere(2, seed=4)
    blob = s.add_mesh(v0, v1, v2, m)
    s.add_object(GameObject(cube, position=(2, 0, 0)))
    s.add_object(GameObject(blob, position=(-1, 0, 1)))
    s.add_object(GameObject(cube, position=(0, 2, 3)))
    s.add_sphere(Sphere((0, -1, 4), 0.7, m))
    s.add_plane(Plane((0, 1, 0), 3, m))
    s.finalize()
    return s.to_device(), s.dynamic_arrays()


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-1, 1, (n, 3)) + np.array([0, 0, -6])
    rd = rng.uniform(-2.5, 2.5, (n, 3)) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return jnp.asarray(ro, jnp.float32), jnp.asarray(rd, jnp.float32)


def _walk(nodes, tris, root, o, d, t, stop):
    """The kernel's per-ray walk (ops/cuda/traverse.cu) in Python."""
    bits = nodes.view(np.int32)
    tiny = 1e-20
    inv = 1.0 / np.where(np.abs(d) < tiny, np.where(d >= 0, tiny, -tiny), d)

    def slab(b, t_best):
        t0, t1 = (b[0:3] - o) * inv, (b[3:6] - o) * inv
        tmin, tmax = np.minimum(t0, t1).max(), np.maximum(t0, t1).min()
        return tmax >= max(0.0, tmin) and tmin < t_best, tmin

    best = -1
    hit, _ = slab(root[0:6], t)
    stack = [root.view(np.int32)[6]] if hit else []
    while stack:
        ref = stack.pop()
        if ref >= 0:
            rec = nodes[ref]
            hl, tl = slab(rec[0:6], t)
            hr, tr = slab(rec[6:12], t)
            kids = sorted([k for k, h in (((tl, bits[ref, 12]), hl),
                                          ((tr, bits[ref, 13]), hr)) if h],
                          key=lambda k: k[0], reverse=True)
            stack += [k[1] for k in kids]
            continue
        start, count = (~ref) >> 3, (~ref) & 7
        for k in range(start, start + count):
            v0, e1, e2 = tris[k, 0:3], tris[k, 4:7], tris[k, 8:11]
            h, th, _, _ = isect.ray_triangle(o, d, v0, v0 + e1, v0 + e2)
            if bool(h) and float(th) < t:
                t, best = float(th), k
        if stop and best >= 0:
            break
    return t, best


@pytest.mark.parametrize('any_hit', [False, True])
def test_tables_walk_matches_reference(scene, any_hit):
    arrays, dyn = scene
    nodes, tris, root = (np.asarray(x) for x in
                         traverse_cuda.kernel_tables(dyn.world))
    assert nodes.shape == (dyn.world.node_box.shape[0], 16)
    assert tris.shape == (dyn.world.tris.shape[0], 12)
    ro, rd = _rays(96, seed=1)
    no_prims = arrays._replace(sphere_pos=jnp.zeros((0, 3)),
                               plane_normal=jnp.zeros((0, 3)))
    t_max = jnp.full((96,), 1e7 if not any_hit else 6.0, jnp.float32)
    want = traverse(no_prims, dyn.world, ro, rd, t_max=t_max,
                    any_hit=any_hit)
    for i in range(96):
        t, best = _walk(nodes, tris, root, np.asarray(ro[i]),
                        np.asarray(rd[i]), float(t_max[i]), any_hit)
        assert (best >= 0) == bool(want.intersected[i])
        if not any_hit and best >= 0:
            assert best == int(want.prim_id[i])
            np.testing.assert_allclose(t, float(want.t[i]), rtol=1e-5)


def _xla_call(world):
    """Stands in for the FFI call: the reference walk on the padded rays."""
    seen = []

    def call(nodes, tris, root, ro, rd, t_init, flags, target=None):
        seen.append(ro.shape[0])
        empty = type('NoPrims', (), dict(sphere_pos=jnp.zeros((0, 3)),
                                         plane_normal=jnp.zeros((0, 3))))
        hit = traverse(empty, world, ro, rd, t_max=t_init,
                       active=(flags & 1) != 0, stop_on_hit=(flags & 2) != 0)
        tri = world.tris[jnp.maximum(hit.prim_id, 0)]
        _, _, u, v = isect.ray_triangle(ro, rd, tri[:, 0:3], tri[:, 3:6],
                                        tri[:, 6:9])
        found = hit.intersected
        return (hit.t, jnp.where(found, hit.prim_id, -1),
                jnp.where(found, u, 0.0), jnp.where(found, v, 0.0))
    return call, seen


@pytest.mark.parametrize('n', [1, 127, 128, 300])
def test_padding_roundtrip(scene, monkeypatch, n):
    """Rays are padded to a multiple of BLOCK for the call and sliced back;
    spheres and planes come from the XLA prepass."""
    arrays, dyn = scene
    call, seen = _xla_call(dyn.world)
    monkeypatch.setattr(traverse_cuda, 'call_kernel', call)
    ro, rd = _rays(n, seed=n)
    got = traverse_cuda.traverse_cuda(arrays, dyn.kernel, ro, rd)
    want = traverse(arrays, dyn.world, ro, rd)
    assert seen == [-(-n // traverse_cuda.BLOCK) * traverse_cuda.BLOCK]
    for name in ('t', 'prim_type', 'prim_id', 'intersected'):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)))
    assert got.u.shape == got.v.shape == (n,)


def test_padding_stop_on_hit(scene, monkeypatch):
    """Per-lane stop-on-hit and inactive lanes survive the flag packing."""
    arrays, dyn = scene
    call, _ = _xla_call(dyn.world)
    monkeypatch.setattr(traverse_cuda, 'call_kernel', call)
    ro, rd = _rays(200, seed=9)
    active = jnp.arange(200) % 5 != 0
    stop = jnp.arange(200) % 2 == 0
    t_max = jnp.full((200,), 7.0, jnp.float32)
    got = traverse_cuda.traverse_cuda(arrays, dyn.kernel, ro, rd, t_max=t_max,
                                      active=active, stop_on_hit=stop)
    want = traverse(arrays, dyn.world, ro, rd, t_max=t_max, active=active,
                    stop_on_hit=stop)
    for name in ('t', 'prim_id', 'intersected'):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)))


def _lower(scene, platform):
    arrays, dyn = scene
    ro, rd = _rays(64)
    return jax.jit(dispatch.trace).trace(arrays, dyn, ro, rd).lower(
        lowering_platforms=(platform,)).as_text()


def test_trace_lowers_kernel_on_gpu(scene):
    assert 'cpt_traverse' in _lower(scene, 'cuda')


def test_trace_lowers_xla_on_cpu(scene):
    text = _lower(scene, 'cpu')
    assert 'cpt_traverse' not in text and 'stablehlo.while' in text


def test_trace_rejects_other_platforms(scene):
    with pytest.raises(NotImplementedError):
        _lower(scene, 'tpu')


@pytest.mark.parametrize('fault', ['build', 'load'])
def test_gpu_unloadable_library_raises(scene, monkeypatch, tmp_path, fault):
    """With a GPU present, a kernel library that fails to build or load
    raises: no fallback to XLA."""
    arrays, dyn = scene
    rule = 'false' if fault == 'build' else 'true'
    (tmp_path / 'Makefile').write_text(f'all:\n\t{rule}\n')
    lib = tmp_path / 'build' / 'libcpt_traverse.so'
    lib.parent.mkdir()
    lib.write_bytes(b'not a shared object')
    monkeypatch.setattr(traverse_cuda, 'CUDA_DIR', str(tmp_path))
    monkeypatch.setattr(traverse_cuda, 'LIB_PATH', str(lib))
    monkeypatch.setattr(traverse_cuda, '_registered', False)
    monkeypatch.setattr(dispatch, 'gpu_present', lambda: True)
    ro, rd = _rays(8)
    with pytest.raises(RuntimeError):
        dispatch.trace(arrays, dyn, ro, rd)


def test_constants_match_kernel_source():
    src = open(os.path.join(traverse_cuda.CUDA_DIR, 'traverse.cu')).read()
    assert int(re.search(r'kBlock = (\d+);', src).group(1)) == \
        traverse_cuda.BLOCK
    assert int(re.search(r'kStack = (\d+);', src).group(1)) == \
        traverse_cuda.STACK


def test_inner_ancestors_bounds_stack(scene):
    """inner_ancestors is the deepest chain of inner nodes, computed by an
    explicit walk of the threaded layout."""
    _, dyn = scene
    meta = np.asarray(dyn.world.node_meta)
    miss, count = meta[:, 0], meta[:, 2]
    deepest, stack = 0, [(0, 0)]
    while stack:
        n, above = stack.pop()
        deepest = max(deepest, above)
        if count[n] == 0:
            stack += [(n + 1, above + 1), (miss[n + 1], above + 1)]
    assert inner_ancestors(miss, count) == deepest > 0


def test_dyn_kernel_tables_follow_world(scene):
    """The scene build stores the kernel's tables of its world BVH once, so
    no trace rebuilds them."""
    _, dyn = scene
    for got, want in zip(dyn.kernel, traverse_cuda.kernel_tables(dyn.world)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.fixture(scope='module')
def cubes():
    """21 unit cubes in a row along x: more instances than one node's
    children, so the top of the world BVH has several levels."""
    s = Scene()
    m = s.add_material(Material.DIFFUSE((0.5,) * 3))
    cube = procedural.add_cube(s, m)
    for i in range(21):
        s.add_object(GameObject(cube, position=(4.0 * i, 0, 0)))
    s.finalize()
    return s.to_device(), s.dynamic_arrays()


def _cube_rays():
    ro = np.array([[4.0 * i, 0.0, -10.0] for i in range(21)], np.float32)
    rd = np.tile(np.array([[0, 0, 1.0]], np.float32), (21, 1))
    return ro, rd


def _trace_both(arrays, dyn, ro, rd, t_max, any_hit, path):
    """(hit?, t, world triangle) per ray, by the CPU trace or by the
    kernel's walk over dyn.kernel."""
    if path == 'trace':
        hit = dispatch.trace(arrays, dyn, jnp.asarray(ro), jnp.asarray(rd),
                             t_max=jnp.asarray(t_max), any_hit=any_hit)
        return (np.asarray(hit.intersected), np.asarray(hit.t),
                np.asarray(hit.prim_id))
    nodes, tris, root = (np.asarray(x) for x in dyn.kernel)
    res = [_walk(nodes, tris, root, o, d, float(tm), any_hit)
           for o, d, tm in zip(ro, rd, t_max)]
    best = np.array([b for _, b in res])
    return best >= 0, np.array([t for t, _ in res]), best


@pytest.mark.parametrize('path', ['trace', 'kernel_walk'])
def test_many_instances_each_ray_hits_its_instance(cubes, path):
    arrays, dyn = cubes
    ro, rd = _cube_rays()
    hit, t, tri = _trace_both(arrays, dyn, ro, rd,
                              np.full(21, 1e7, np.float32), False, path)
    assert hit.all()
    np.testing.assert_allclose(t, 9.5, rtol=1e-5)
    inst = np.asarray(dyn.world.tri_inst)[tri]
    np.testing.assert_array_equal(inst, np.arange(21))


@pytest.mark.parametrize('path', ['trace', 'kernel_walk'])
def test_t_max_respected(cubes, path):
    """A shadow-style ray capped before the cube's face (t = 9.5) misses;
    capped after it, it is occluded."""
    arrays, dyn = cubes
    ro, rd = _cube_rays()
    t_max = np.where(np.arange(21) % 2 == 0, 9.0, 10.0).astype(np.float32)
    hit, _, _ = _trace_both(arrays, dyn, ro, rd, t_max, True, path)
    np.testing.assert_array_equal(hit, np.arange(21) % 2 == 1)


def test_empty_world_skips_the_kernel(monkeypatch):
    """A scene of analytic primitives only has empty kernel tables; the
    wrapper then answers from the XLA prepass without a library call."""
    s = Scene()
    m = s.add_material(Material.DIFFUSE((0.5,) * 3))
    s.add_sphere(Sphere((0, 0, 4), 1.0, m))
    s.finalize()
    arrays, dyn = s.to_device(), s.dynamic_arrays()
    assert dyn.kernel.nodes.shape == (0, 16)

    def no_call(*args):
        raise AssertionError('the kernel was called on an empty world')
    monkeypatch.setattr(traverse_cuda, 'call_kernel', no_call)
    ro = jnp.zeros((4, 3), jnp.float32)
    rd = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (4, 1))
    hit = traverse_cuda.traverse_cuda(arrays, dyn.kernel, ro, rd)
    assert np.asarray(hit.intersected).all()
    np.testing.assert_allclose(np.asarray(hit.t), 3.0, rtol=1e-6)
