"""SBVH spatial-split builder (accel/native build_bvh_sbvh, CPT_SBVH=1).

Locks the opt-in quality build's CORRECTNESS: duplicated references must
never change a closest hit, every source triangle must stay reachable, and
the light list must not double-count an emissive triangle that spatial
splits reference from several leaves.

SBVH stays opt-in and the binned builder remains the default. Reference
builder being improved upon: src/bvhBuilder.h:35-274.
"""
import os

import numpy as np
import pytest

from cuda_pathtracer_tpu.accel import native
from cuda_pathtracer_tpu.accel.bvh import build_bvh_numpy

def _random_mesh(n, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.random((n, 3), np.float32) * 10
    v0 = c + rng.random((n, 3), np.float32)
    v1 = c + rng.random((n, 3), np.float32)
    v2 = c + rng.random((n, 3), np.float32)
    # a few LARGE triangles that straddle everything (spatial-split bait)
    for i in range(min(8, n)):
        v0[i] = (0, 0, i)
        v1[i] = (10, 0, i)
        v2[i] = (0, 10, i)
    return v0.astype(np.float32), v1.astype(np.float32), v2.astype(np.float32)


def _closest_hit_brute(v0, v1, v2, o, d):
    e1 = v1 - v0
    e2 = v2 - v0
    h = np.cross(d[None], e2)
    a = (e1 * h).sum(-1)
    ok_a = np.abs(a) >= 1e-9
    f = np.where(ok_a, 1.0 / np.where(ok_a, a, 1.0), 0.0)
    s = o[None] - v0
    u = f * (s * h).sum(-1)
    q = np.cross(s, e1)
    v = f * (d[None] * q).sum(-1)
    t = f * (e2 * q).sum(-1)
    ok = ok_a & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 1e-4)
    return np.where(ok, t, np.inf).min()


def _walk_bvh(nodes, v0, v1, v2, o, d):
    """Reference binary walk over (possibly duplicated-ref) BVHNodes."""
    best = np.inf
    stack = [0]
    inv = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d)
    while stack:
        i = stack.pop()
        t0 = (nodes.vmin[i] - o) * inv
        t1 = (nodes.vmax[i] - o) * inv
        tmin = np.minimum(t0, t1).max()
        tmax = np.maximum(t0, t1).min()
        if tmax < max(tmin, 0.0) or tmin > best:
            continue
        if nodes.leaf_count[i] > 0:
            s, c = nodes.leaf_start[i], nodes.leaf_count[i]
            tris = nodes.perm[s:s + c]
            t = _closest_hit_brute(v0[tris], v1[tris], v2[tris], o, d)
            best = min(best, t)
        else:
            stack.append(nodes.left[i])
            stack.append(nodes.left[i] + 1)
    return best


def test_sbvh_closest_hit_parity():
    v0, v1, v2 = _random_mesh(400)
    nodes = native.build_bvh_sbvh_native(v0, v1, v2, alpha=0.0,
                                         dup_factor=2.0)
    assert nodes is not None
    n = len(v0)
    assert len(nodes.perm) >= n
    # every source triangle reachable
    assert set(np.unique(nodes.perm)) == set(range(n))
    # leaves stay within the wide-collapse bound
    leaf = nodes.leaf_count[nodes.leaf_count > 0]
    assert leaf.max() <= 4
    rng = np.random.default_rng(7)
    for _ in range(40):
        o = rng.random(3).astype(np.float32) * 12 - 1
        d = rng.standard_normal(3).astype(np.float32)
        d /= np.linalg.norm(d)
        t_ref = _closest_hit_brute(v0, v1, v2, o, d)
        t_bvh = _walk_bvh(nodes, v0, v1, v2, o, d)
        if np.isinf(t_ref):
            assert np.isinf(t_bvh)
        else:
            assert abs(t_ref - t_bvh) < 1e-5


def test_sbvh_scene_light_dedup():
    """An emissive model built under CPT_SBVH keeps ONE light entry per
    source triangle even when spatial splits duplicate references."""
    from cuda_pathtracer_tpu.scene.scene import Scene, Material, GameObject
    os.environ['CPT_SBVH'] = '1'
    os.environ['CPT_SBVH_ALPHA'] = '0'
    try:
        v0, v1, v2 = _random_mesh(200, seed=3)
        sc = Scene()
        m = sc.add_material(Material(emission=(5.0, 5.0, 5.0)))
        mid = sc.add_mesh(v0, v1, v2, m)
        sc.add_object(GameObject(mid))
        sc.finalize()
        model = sc.models[0]
        # duplication happened (the bait triangles straddle everything)
        assert model.nr_triangles > 200
        overrides = np.full(1, -1, np.int32)
        lt, li = sc.extract_triangle_lights(overrides)
        assert len(lt) == 200  # one entry per SOURCE triangle
    finally:
        os.environ.pop('CPT_SBVH', None)
        os.environ.pop('CPT_SBVH_ALPHA', None)


def test_sbvh_vs_binned_node_quality():
    """The SBVH tree is valid and its leaves cover no more area than 2x the
    binned tree's (sanity: clipping should TIGHTEN leaf boxes)."""
    v0, v1, v2 = _random_mesh(400, seed=1)
    sb = native.build_bvh_sbvh_native(v0, v1, v2, alpha=0.0, dup_factor=2.0)
    bn = build_bvh_numpy(v0, v1, v2)

    def leaf_area(nodes):
        m = nodes.leaf_count > 0
        d = np.maximum(nodes.vmax[m] - nodes.vmin[m], 0)
        return (2 * (d[:, 0] * d[:, 1] + d[:, 0] * d[:, 2]
                     + d[:, 1] * d[:, 2])).sum()

    assert leaf_area(sb) < 2.0 * leaf_area(bn)
