"""Device-side scene representation (the reference's SceneBuffers).

Equivalent of the reference's SceneBuffers (src/types.h:689-703) plus the
device constants DTriangleLights / skydome / blue noise that the reference
keeps in __constant__ memory or texture objects (src/globals.h:8-28,
src/pathtracer.h:73-222). Split into:

  * SceneArrays  — static for a scene's lifetime (uploaded once, like the
    cudaMemcpy block in Pathtracer::Init, src/pathtracer.h:129-221)
  * DynamicArrays — instance transforms + the merged world BVH, refreshed when
    the scene is invalidated (mirroring the per-clear instance/top-BVH upload
    at src/pathtracer.h:245-246)

Everything is an SoA jnp array; the whole thing is a pytree, so it flows
through jit/shard_map unchanged and shards trivially (replicated) over a mesh.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .textures import TextureStack
from ..ops.traverse import WorldArrays
from ..ops.traverse_cuda import KernelTables


class SceneArrays(NamedTuple):
    # triangle attributes, in global model-space order (TriangleD, types.h:85-96)
    tri_normal: jnp.ndarray      # f32[T, 3]
    tri_tangent: jnp.ndarray     # f32[T, 3]
    tri_bitangent: jnp.ndarray   # f32[T, 3]
    tri_uv: jnp.ndarray          # f32[T, 6] uv0|uv1|uv2
    tri_mat: jnp.ndarray         # i32[T]

    # material table (Material, types.h:33-56)
    mat_diffuse: jnp.ndarray     # f32[M, 3]
    mat_specular: jnp.ndarray    # f32[M, 3]
    mat_emission: jnp.ndarray    # f32[M, 3]
    mat_reflect: jnp.ndarray     # f32[M]
    mat_glossy: jnp.ndarray      # f32[M]
    mat_transmit: jnp.ndarray    # f32[M]
    mat_ior: jnp.ndarray         # f32[M]
    mat_absorption: jnp.ndarray  # f32[M, 3]
    mat_tex: jnp.ndarray         # i32[M]  (-1 = none)
    mat_normal_tex: jnp.ndarray  # i32[M]  (-1 = none)

    textures: TextureStack

    # analytic primitives
    sphere_pos: jnp.ndarray      # f32[S, 3]
    sphere_radius: jnp.ndarray   # f32[S]
    sphere_mat: jnp.ndarray      # i32[S]
    plane_normal: jnp.ndarray    # f32[P, 3]
    plane_d: jnp.ndarray         # f32[P]
    plane_mat: jnp.ndarray       # i32[P]

    # lights
    point_light_pos: jnp.ndarray    # f32[L, 3]
    point_light_color: jnp.ndarray  # f32[L, 3]
    light_tri: jnp.ndarray          # i32[TL] global triangle id (emissive)
    light_inst: jnp.ndarray         # i32[TL] owning instance

    # environment
    sky_img: jnp.ndarray         # f32[Hs, Ws, 3] equirect, bottom-row-first
    sky_pairs: jnp.ndarray       # f32[Hs*Ws, 6] horizontal texel pairs
                                 #   (models/sky.build_sky_pairs): bilinear
                                 #   fetch = 2 row gathers instead of 4
    blue_noise: jnp.ndarray      # f32[Hb, Wb]

    # ---- packed single-gather lookup rows: every per-hit lookup is one
    # fat row instead of many thin ones ----
    mat_packed: jnp.ndarray      # f32[M, 24]: diffuse|specular|emission|
                                 #   reflect|glossy|transmit|ior|absorption|
                                 #   tex(bitcast)|ntex(bitcast)
    tri_packed: jnp.ndarray      # f32[T, 16]: normal|tangent|bitangent|uv6|
                                 #   mat(bitcast)
    sphere_packed: jnp.ndarray   # f32[S, 8]: pos|radius|mat(bitcast)
    plane_packed: jnp.ndarray    # f32[P, 8]: normal|d|mat(bitcast)

    # shape-as-static flag: f32[1] if any material has a normal map, f32[0]
    # otherwise. shade() gates the normal-map texture gather on the SHAPE
    # (static under jit), so scenes without normal maps skip the gather and
    # TBN math entirely at trace time.
    nmap_marker: jnp.ndarray

    # path guiding radiance cache (RadianceCache, types.h:98-104); mutable —
    # threaded through the render step functionally
    # (kept in DynamicArrays? no: per-triangle, static shape) ->
    # stored separately in the engine state.


class DynamicArrays(NamedTuple):
    world: WorldArrays
    inst_transform: jnp.ndarray  # f32[I, 3, 4]
    inst_inv: jnp.ndarray        # f32[I, 3, 4]
    inst_mat: jnp.ndarray        # i32[I] material override (-1 = none)
    # world-space emissive light triangles, precomputed per invalidation so the
    # NEE inner loop (kernels.h:672-752) needs no transform gathers at all
    light_v0w: jnp.ndarray       # f32[TL, 3]
    light_v1w: jnp.ndarray       # f32[TL, 3]
    light_v2w: jnp.ndarray       # f32[TL, 3]
    light_normal_w: jnp.ndarray  # f32[TL, 3]
    light_emission_w: jnp.ndarray  # f32[TL, 3]
    # the GPU traversal kernel's tables, derived from `world` whenever it is
    # built or refitted (ops/traverse_cuda.kernel_tables)
    kernel: KernelTables
    light_packed: jnp.ndarray    # f32[TL, 16]: v0|v1|v2|normal|emission
    inst_packed: jnp.ndarray     # f32[I, 16]: transform(12)|override(bitcast)
    tri_meta: jnp.ndarray        # f32[WT, 32]: gid|inst as float values,
                                 #   cols 2:11 world verts v0|v1|v2 (copies
                                 #   of world.tris that shade no longer
                                 #   reads: trace returns barycentrics),
                                 #   cols 11:27 the baked
                                 #   per-tri shade attrs (model-space
                                 #   normal|tangent|bitangent, uvs, mid) —
                                 #   shade needs ONE gather per bounce
                                 #   (< 2^24, so exact in f32)
    # per-instance world-tri block map, f32[I, 3] rows sorted by block base:
    # (base=wtri_base, inst, delta=model_tri_start-base). World triangles are
    # per-instance CONTIGUOUS blocks preserving model order
    # (accel/toplevel.py::build_world_bvh emit), so shade recovers
    # gid = pid + delta and inst by an unrolled compare/select chain over
    # these rows instead of a [WT,2] tri_meta gather. Values < 2^24:
    # f32-exact.
    tri_blocks: jnp.ndarray


def material_id_of(scene: SceneArrays, dyn: DynamicArrays, gid, inst):
    """Triangle material with instance override
    (getColliderMaterialID, src/kernels.h:88-99)."""
    override = dyn.inst_mat[inst]
    return jnp.where(override >= 0, override, scene.tri_mat[gid])


def empty_like_lights():
    return (jnp.zeros((0,), jnp.int32), jnp.zeros((0,), jnp.int32))


def pack_instances(transforms: np.ndarray, inverses: np.ndarray,
                   overrides: np.ndarray) -> tuple:
    return (jnp.asarray(transforms, jnp.float32),
            jnp.asarray(inverses, jnp.float32),
            jnp.asarray(overrides, jnp.int32))
