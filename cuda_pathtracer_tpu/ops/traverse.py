"""Stackless BVH traversal over ray wavefronts (pure-JAX reference path).

This replaces the reference's divergent short-stack traversal
(traverseBVHStack / traverseTopLevel, src/kernels.h:202-387) with a uniform
loop over the threaded world BVH (see accel/flatten.py): every iteration does
two row-gathers (node box+meta), one slab test, an unconditional 4-triangle
leaf test, and a select for the next node — fully vectorized across the
wavefront, no per-ray stack, no ray transforms (triangles are pre-baked to
world space).

Spheres and planes are brute-forced before the tree walk, exactly like
traverseTopLevel (src/kernels.h:286-320).

This walk is the CPU path and the semantics reference; the CUDA per-ray
kernel (ops/traverse_cuda.py, the GPU path) implements the same contract and
is tested against it.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import intersect as isect
from ..constants import BVH_LEAF_SIZE, T_MAX

# primitive type tags (reference PRIMITIVE_TYPE, src/types.h:296)
PRIM_TRIANGLE = 0
PRIM_SPHERE = 1
PRIM_PLANE = 2


class WorldArrays(NamedTuple):
    """Device-side flat world BVH (from accel/toplevel.build_world_bvh)."""
    node_box: jnp.ndarray    # f32[N, 6]  vmin | vmax
    node_meta: jnp.ndarray   # i32[N, 3]  miss | leaf_start | leaf_count
    tris: jnp.ndarray        # f32[WT, 9] v0 | v1 | v2 (world space)
    tri_gid: jnp.ndarray     # i32[WT]
    tri_inst: jnp.ndarray    # i32[WT]

    @staticmethod
    def from_host(wb) -> 'WorldArrays':
        node_box = np.concatenate([wb.vmin, wb.vmax], axis=1)
        node_meta = np.stack([wb.miss, wb.leaf_start, wb.leaf_count], axis=1)
        tris = np.concatenate([wb.tri_v0, wb.tri_v1, wb.tri_v2], axis=1)
        return WorldArrays(jnp.asarray(node_box), jnp.asarray(node_meta),
                           jnp.asarray(tris), jnp.asarray(wb.tri_gid),
                           jnp.asarray(wb.tri_inst))


class Hit(NamedTuple):
    t: jnp.ndarray          # f32[B]
    prim_type: jnp.ndarray  # i32[B] (valid only when hit)
    prim_id: jnp.ndarray    # i32[B] world-triangle index / sphere index / plane index
    intersected: jnp.ndarray  # bool[B]
    # barycentric (u, v) of the winning triangle. ops/dispatch.trace always
    # fills them (the GPU kernel from its leaf test, the XLA path by
    # re-intersecting, as the reference's texturing path does,
    # src/kernels.h:585-619); the raw traversal here leaves them None.
    u: jnp.ndarray | None = None  # f32[B]
    v: jnp.ndarray | None = None  # f32[B]


def _leaf_intersect(world: WorldArrays, ro, rd, leaf_start, leaf_count, t_best):
    """Unconditional fixed-width leaf test: gathers BVH_LEAF_SIZE triangles and
    masks the tail. Returns (best_t, best_idx, any_better)."""
    wt = world.tris.shape[0]
    lanes = jnp.arange(BVH_LEAF_SIZE, dtype=jnp.int32)
    idx = jnp.clip(leaf_start[..., None] + lanes, 0, wt - 1)       # [B, L]
    tri = world.tris[idx]                                           # [B, L, 9]
    v0, v1, v2 = tri[..., 0:3], tri[..., 3:6], tri[..., 6:9]
    hit, t, _, _ = isect.ray_triangle(ro[..., None, :], rd[..., None, :], v0, v1, v2)
    valid = hit & (lanes < leaf_count[..., None]) & (t < t_best[..., None])
    t_masked = jnp.where(valid, t, T_MAX)
    # min-reduce + equality re-select instead of a per-lane take_along_axis
    best_t = jnp.min(t_masked, axis=-1)
    best_idx = jnp.min(jnp.where(t_masked == best_t[..., None], idx,
                                 jnp.int32(2**30)), axis=-1)
    any_better = jnp.any(valid, axis=-1)
    return best_t, best_idx, any_better


def _primitives_prepass(scene, ro, rd, t_init, any_hit: bool):
    """Brute-force spheres and planes (src/kernels.h:286-320).
    Returns (t, prim_type, prim_id, found)."""
    B = ro.shape[:-1]
    t = t_init
    ptype = jnp.zeros(B, jnp.int32)
    pid = jnp.full(B, -1, jnp.int32)
    found = jnp.zeros(B, bool)

    def _fold(hit, ts, t, ptype, pid, found, tag):
        better = hit & (ts < t[..., None])
        ts_m = jnp.where(better, ts, T_MAX)
        bt = jnp.min(ts_m, axis=-1)
        j = jnp.min(jnp.where(ts_m == bt[..., None],
                              jnp.arange(ts.shape[-1], dtype=jnp.int32),
                              jnp.int32(2**30)), axis=-1)
        got = jnp.any(better, axis=-1)
        return (jnp.where(got, bt, t),
                jnp.where(got, tag, ptype),
                jnp.where(got, j, pid),
                found | got)

    if scene.sphere_pos.shape[0] > 0:
        hit, ts = isect.ray_sphere(ro[..., None, :], rd[..., None, :],
                                   scene.sphere_pos, scene.sphere_radius)  # [B, S]
        t, ptype, pid, found = _fold(hit, ts, t, ptype, pid, found, PRIM_SPHERE)

    if scene.plane_normal.shape[0] > 0:
        hit, ts = isect.ray_plane(ro[..., None, :], rd[..., None, :],
                                  scene.plane_normal, scene.plane_d)
        t, ptype, pid, found = _fold(hit, ts, t, ptype, pid, found, PRIM_PLANE)

    return t, ptype, pid, found


def traverse(scene, world: WorldArrays, ro, rd, t_max=None, active=None,
             any_hit: bool = False, stop_on_hit=None) -> Hit:
    """Closest-hit (or any-hit) trace of a ray batch against the scene.

    scene: device scene arrays providing sphere_pos/sphere_radius,
           plane_normal/plane_d (see scene/device.py)
    ro/rd: f32[B, 3]; t_max: f32[B] ray length cap; active: bool[B]
    """
    B = ro.shape[:-1]
    if t_max is None:
        t_max = jnp.full(B, T_MAX, jnp.float32)
    if active is None:
        active = jnp.ones(B, bool)

    t0, ptype0, pid0, found0 = _primitives_prepass(scene, ro, rd, t_max, any_hit)

    if stop_on_hit is None:
        stop_on_hit = jnp.full(B, bool(any_hit))

    inv_rd = isect.safe_inv_dir(rd)
    n_nodes = world.node_box.shape[0]

    # stop-on-hit lanes can stop as soon as the prepass found an occluder
    start_node = jnp.where(active & ~(stop_on_hit & found0),
                           0, -1).astype(jnp.int32)

    def cond(state):
        node, _, _, _ = state
        return jnp.any(node >= 0)

    def body(state):
        node, t, tri_idx, tri_found = state
        live = node >= 0
        ni = jnp.maximum(node, 0)
        box = world.node_box[ni]                      # [B, 6]
        meta = world.node_meta[ni]                    # [B, 3]
        miss, lstart, lcount = meta[..., 0], meta[..., 1], meta[..., 2]
        is_leaf = lcount > 0

        box_hit, _ = isect.slab_test(ro, inv_rd, box[..., 0:3], box[..., 3:6], t)

        lt, lidx, lfound = _leaf_intersect(world, ro, rd, lstart, lcount, t)
        take = live & is_leaf & lfound
        t = jnp.where(take, lt, t)
        tri_idx = jnp.where(take, lidx, tri_idx)
        tri_found = tri_found | take

        nxt = jnp.where(is_leaf | ~box_hit, miss, node + 1)
        nxt = jnp.where(stop_on_hit & take, -1, nxt)  # lane satisfied: stop
        node = jnp.where(live, nxt, node)
        return node, t, tri_idx, tri_found

    if n_nodes > 0:
        init = (start_node, t0, jnp.full(B, -1, jnp.int32), jnp.zeros(B, bool))
        _, t, tri_idx, tri_found = jax.lax.while_loop(cond, body, init)
    else:
        t, tri_idx, tri_found = t0, jnp.full(B, -1, jnp.int32), jnp.zeros(B, bool)

    ptype = jnp.where(tri_found, PRIM_TRIANGLE, ptype0)
    pid = jnp.where(tri_found, tri_idx, pid0)
    intersected = active & (tri_found | found0)
    return Hit(t=t, prim_type=ptype, prim_id=pid, intersected=intersected)
