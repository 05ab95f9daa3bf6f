"""tri_blocks arithmetic pid->(gid, inst) decode == tri_meta cols 0|1.

The world-tri layout is per-instance contiguous blocks preserving model
order (accel/toplevel.py::build_world_bvh), which shade exploits to replace
the [WT,2] gid|inst gather with an unrolled compare/select decode
(models/shading.py). This locks the equivalence on a multi-model,
multi-instance scene (shared models => shared gid ranges) built from
procedural meshes."""
import numpy as np

from cuda_pathtracer_tpu.scene import procedural
from cuda_pathtracer_tpu.scene.scene import Scene, Material, GameObject


def _decode(blocks, pid):
    bi, ii, dd = blocks[:, 0], blocks[:, 1], blocks[:, 2]
    inst = np.full(pid.shape, ii[0], np.float32)
    delta = np.full(pid.shape, dd[0], np.float32)
    for k in range(1, len(blocks)):
        ge = pid.astype(np.float32) >= bi[k]
        inst = np.where(ge, ii[k], inst)
        delta = np.where(ge, dd[k], delta)
    return (pid + delta).astype(np.int32), inst.astype(np.int32)


def test_decode_matches_tri_meta():
    scene = Scene()
    m = scene.add_material(Material.DIFFUSE((0.5,) * 3))
    teapot = scene.add_mesh(*procedural._displaced_sphere(2, seed=2), m)
    cube = procedural.add_cube(scene, m)
    # interleave instances of shared models so block order != inst order
    scene.add_object(GameObject(cube, position=(5, 0, 0)))
    scene.add_object(GameObject(teapot, position=(0, 0, 0)))
    scene.add_object(GameObject(cube, position=(-5, 0, 0)))
    scene.add_object(GameObject(teapot, position=(0, 5, 0)))
    scene.finalize()
    dyn = scene.dynamic_arrays()

    tm = np.asarray(dyn.tri_meta)
    blocks = np.asarray(dyn.tri_blocks)
    assert blocks.shape == (4, 3)
    assert np.all(np.diff(blocks[:, 0]) > 0), 'bases must be sorted'

    pid = np.arange(tm.shape[0], dtype=np.int32)
    gid, inst = _decode(blocks, pid)
    np.testing.assert_array_equal(gid, tm[:, 0].astype(np.int32))
    np.testing.assert_array_equal(inst, tm[:, 1].astype(np.int32))
