"""Host-side scene graph: models, materials, instances, lights, handlers.

Behavioral mirror of the reference Scene (src/scene.h:120-402) and its OBJ/MTL
material derivation rules (src/scene.h:182-247), rebuilt on numpy: the
per-face loop is vectorized, and the per-model BVH build + world-BVH merge
live in accel/. The class is host-only; `to_device()` exports the static
SceneArrays and `dynamic_arrays()` the per-invalidation instance + world-BVH
state (see scene/device.py).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import jax.numpy as jnp

from . import objloader
from .textures import TextureAtlas, load_image
from .device import SceneArrays, DynamicArrays
from ..accel.bvh import build_bvh
from ..accel.flatten import thread_bvh, ThreadedBVH, inner_ancestors
from ..accel.toplevel import build_world_bvh
from ..core import transforms as tf
from ..ops.traverse import WorldArrays
from ..ops.traverse_cuda import STACK as TRAVERSE_STACK, kernel_tables
from ..models import sky as _sky_mod
from ..constants import EPS

NO_MATERIAL = -1  # the reference's 0xffffffff override marker


@dataclass
class Material:
    """Host material (reference Material, src/types.h:33-56)."""
    diffuse_color: tuple = (1.0, 1.0, 1.0)
    specular_color: tuple = (0.0, 0.0, 0.0)
    emission: tuple = (0.0, 0.0, 0.0)
    reflect: float = 0.0
    glossy: float = 0.0
    transmit: float = 0.0
    refractive_index: float = 0.0
    absorption: tuple = (0.0, 0.0, 0.0)
    texture: int = -1         # atlas id, -1 = none
    normal_texture: int = -1

    @staticmethod
    def DIFFUSE(color) -> 'Material':
        return Material(diffuse_color=tuple(float(c) for c in color))


@dataclass
class GameObject:
    """src/types.h:416-429."""
    model_id: int
    kind: int = 0
    material_id: int = NO_MATERIAL
    position: np.ndarray = field(default_factory=lambda: np.zeros(3))
    rotation: np.ndarray = field(default_factory=lambda: np.zeros(3))
    scale: np.ndarray = field(default_factory=lambda: np.ones(3))

    def __post_init__(self):
        self.position = np.asarray(self.position, np.float64).copy()
        self.rotation = np.asarray(self.rotation, np.float64).copy()
        self.scale = np.asarray(self.scale, np.float64).copy()


@dataclass
class Sphere:
    pos: tuple
    radius: float
    material: int


@dataclass
class Plane:
    normal: tuple
    d: float
    material: int


@dataclass
class PointLight:
    pos: tuple
    color: tuple


@dataclass
class Model:
    triangle_start: int
    nr_triangles: int
    bvh: ThreadedBVH


class Scene:
    """The scriptable scene container (src/scene.h:120-402)."""

    def __init__(self, asset_dirs=()):
        self.asset_dirs = list(asset_dirs) or ['.']
        self.models: list[Model] = []
        self.objects: list[GameObject] = []
        self.materials: list[Material] = []
        self.spheres: list[Sphere] = []
        self.planes: list[Plane] = []
        self.point_lights: list[PointLight] = []
        self.handlers: list[Callable] = []
        self.atlas = TextureAtlas()
        self.invalid = False
        self.attached = 0
        self.interactive_depth = 1
        self.interactive_samples = 1
        # concatenated triangle data (allVertices / allVertexData)
        self._v0 = np.zeros((0, 3), np.float32)
        self._v1 = np.zeros((0, 3), np.float32)
        self._v2 = np.zeros((0, 3), np.float32)
        self._normal = np.zeros((0, 3), np.float32)
        self._tangent = np.zeros((0, 3), np.float32)
        self._bitangent = np.zeros((0, 3), np.float32)
        self._uv = np.zeros((0, 6), np.float32)
        self._tri_mat = np.zeros((0,), np.int32)
        # SBVH duplicate-reference mask: True for 2nd+ stored occurrences of
        # a source triangle (spatial splits reference a straddling triangle
        # from several leaves). Light extraction skips them so each emissive
        # triangle appears in the light list ONCE, like the reference's
        # unique-triangle scan (src/pathtracer.h:154-170).
        self._tri_dup = np.zeros((0,), bool)
        self._version = 0          # bumped whenever dynamic state changes
        self._dyn_cache = None     # (version, DynamicArrays)
        self._refit_templates = None   # accel/refit.py model-space tables
        self._refit_key = None
        self._full_dyn = None

    # -- scriptable API (the chai-registered surface, sceneBuilder.h:283-301) --

    def add_material(self, material: Material) -> int:
        self.materials.append(material)
        return len(self.materials) - 1

    def add_sphere(self, sphere: Sphere):
        self.spheres.append(sphere)

    def add_plane(self, plane: Plane):
        self.planes.append(plane)

    def add_point_light(self, light: PointLight):
        self.point_lights.append(light)

    def add_object(self, obj: GameObject) -> int:
        self.objects.append(obj)
        return len(self.objects) - 1

    def add_handler(self, handler: Callable):
        self.handlers.append(handler)

    def invalidate(self):
        self.invalid = True
        self._version += 1

    # camelCase aliases matching the reference API names
    addMaterial = add_material
    addSphere = add_sphere
    addPlane = add_plane
    addPointLight = add_point_light
    addObject = add_object
    addHandler = add_handler

    def _resolve(self, filename: str) -> str:
        if os.path.exists(filename):
            return filename
        for d in self.asset_dirs:
            cand = os.path.join(d, os.path.basename(filename))
            if os.path.exists(cand):
                return cand
        raise FileNotFoundError(f'{filename} (searched {self.asset_dirs})')

    def add_model(self, filename: str, scale=1.0, rotation=(0, 0, 0),
                  offset=(0, 0, 0), material: int = 0,
                  use_mtl: bool = False) -> int:
        """Scene::addModel (src/scene.h:159-347): OBJ parse, MTL->Material
        derivation, vertex bake, per-triangle attributes, BVH build."""
        import sys
        import time as _time
        print(f'Loading model {filename}', file=sys.stderr)
        path = self._resolve(filename)
        mesh = objloader.load_obj(path, self.asset_dirs)

        # --- MTL -> Material (src/scene.h:182-247) ---
        material_ids = np.full(max(len(mesh.materials), 1), material, np.int32)
        mat_has_nmap = np.zeros(max(len(mesh.materials), 1), bool)
        mat_uv_offset = np.zeros((max(len(mesh.materials), 1), 2), np.float32)
        if use_mtl:
            for m_i, mm in enumerate(mesh.materials):
                mat = Material.DIFFUSE((1, 1, 1))
                mat.diffuse_color = tuple(np.clip(mm.diffuse, 0.0, 1.0))
                mat.specular_color = tuple(mm.specular)
                mat.transmit = 1.0 - mm.dissolve
                mat.reflect = float(np.mean(mm.specular))
                mat.glossy = mm.shininess / 4000.0
                s = mat.transmit + mat.reflect
                if s > 1.0:
                    mat.transmit /= s
                    mat.reflect /= s
                if mat.transmit > EPS:   # "make glass white" (scene.h:206-209)
                    mat.diffuse_color = (1.0, 1.0, 1.0)
                mat.refractive_index = mm.ior
                if mm.diffuse_texname:
                    mat.texture = self.atlas.add_path(mm.diffuse_texname,
                                                      self.asset_dirs)
                    mat_uv_offset[m_i] = mm.diffuse_tex_offset
                if mm.normal_texname:
                    mat.normal_texture = self.atlas.add_path(mm.normal_texname,
                                                             self.asset_dirs)
                    mat_has_nmap[m_i] = True
                material_ids[m_i] = self.add_material(mat)

        # --- vectorized per-triangle bake (src/scene.h:259-336) ---
        bake = tf.model_bake(scale, rotation, offset)
        nt = len(mesh.tri_v)
        if nt == 0:
            raise ValueError(f'no triangles in {path}')
        v = mesh.vertices[mesh.tri_v]                       # [T, 3, 3]
        v = tf.transform_points(bake, v.reshape(-1, 3)).reshape(nt, 3, 3)
        v0, v1, v2 = (v[:, 0].astype(np.float32), v[:, 1].astype(np.float32),
                      v[:, 2].astype(np.float32))

        has_uv = len(mesh.texcoords) > 0
        if has_uv:
            vt = np.maximum(mesh.tri_vt, 0)
            uv = mesh.texcoords[vt]                          # [T, 3, 2]
            uv = np.where((mesh.tri_vt >= 0)[..., None], uv, 0.0)
        else:
            uv = np.zeros((nt, 3, 2), np.float32)

        fmat = np.where(mesh.tri_mat >= 0, mesh.tri_mat, 0)
        if use_mtl:
            # MTL texcoord origin offset (scene.h:275-283)
            uv = uv + mat_uv_offset[fmat][:, None, :]
            tri_materials = np.where(mesh.tri_mat >= 0,
                                     material_ids[fmat], material).astype(np.int32)
        else:
            tri_materials = np.full(nt, material, np.int32)

        # flat normal: vertex 0's normal, geometric fallback (scene.h:293-305)
        e1 = v1 - v0
        e2 = v2 - v0
        geo_n = np.cross(e1, e2)
        geo_n /= np.maximum(np.linalg.norm(geo_n, axis=-1, keepdims=True), 1e-30)
        has_n = np.all(mesh.tri_vn >= 0, axis=1) & (len(mesh.normals) > 0)
        if len(mesh.normals) > 0:
            n0 = mesh.normals[np.maximum(mesh.tri_vn[:, 0], 0)]
        else:
            n0 = geo_n
        normal = np.where(has_n[:, None], n0, geo_n).astype(np.float32)

        # tangent frame for normal-mapped faces (scene.h:308-328)
        tangent = np.zeros((nt, 3), np.float32)
        bitangent = np.zeros((nt, 3), np.float32)
        if use_mtl and mat_has_nmap.any():
            need = mat_has_nmap[fmat] & (mesh.tri_mat >= 0)
            duv1 = uv[:, 1] - uv[:, 0]
            duv2 = uv[:, 2] - uv[:, 0]
            denom = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
            f = 1.0 / np.where(np.abs(denom) < 1e-30, 1.0, denom)
            tg = f[:, None] * (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2)
            bt = f[:, None] * (duv1[:, 0:1] * e2 - duv2[:, 0:1] * e1)
            bad = ~np.isfinite(tg).all(axis=1) | ~np.isfinite(bt).all(axis=1) \
                | (np.abs(denom) < 1e-30)
            # NaN fallback basis (scene.h:321-327)
            w = normal
            helper = np.where((np.abs(w[:, 0]) > 0.1)[:, None],
                              np.array([0.0, 1.0, 0.0]), np.array([1.0, 0.0, 0.0]))
            u_f = np.cross(helper, w)
            u_f /= np.maximum(np.linalg.norm(u_f, axis=1, keepdims=True), 1e-30)
            v_f = np.cross(w, u_f)
            v_f /= np.maximum(np.linalg.norm(v_f, axis=1, keepdims=True), 1e-30)
            tg = np.where(bad[:, None], u_f, tg)
            bt = np.where(bad[:, None], v_f, bt)
            tangent = np.where(need[:, None], tg, 0.0).astype(np.float32)
            bitangent = np.where(need[:, None], bt, 0.0).astype(np.float32)

        return self._append_model(v0, v1, v2, normal, tangent, bitangent,
                                  uv.reshape(nt, 6).astype(np.float32),
                                  tri_materials)

    addModel = add_model

    def add_mesh(self, v0, v1, v2, material: int, normals=None, uv=None) -> int:
        """Register a raw triangle soup as a model (used by the procedural
        stand-in scenes and by tests; no reference equivalent — the reference
        only ingests OBJ files)."""
        nt = len(v0)
        v0 = np.asarray(v0, np.float32)
        v1 = np.asarray(v1, np.float32)
        v2 = np.asarray(v2, np.float32)
        if normals is None:
            n = np.cross(v1 - v0, v2 - v0)
            normals = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                                     1e-30)
        zeros = np.zeros((nt, 3), np.float32)
        uv6 = np.zeros((nt, 6), np.float32) if uv is None \
            else np.asarray(uv, np.float32).reshape(nt, 6)
        return self._append_model(v0, v1, v2,
                                  np.asarray(normals, np.float32),
                                  zeros, zeros, uv6,
                                  np.full(nt, material, np.int32))

    def _append_model(self, v0, v1, v2, normal, tangent, bitangent,
                      uv6, tri_materials) -> int:
        """BVH over the model's block, permute the block, register the model.
        Boot logging mirrors the reference (scene.h:338-343)."""
        import sys
        import time as _time
        nt = len(v0)
        print(f'Building a BVH over {nt} triangles', file=sys.stderr)
        t0 = _time.perf_counter()
        nodes = build_bvh(v0, v1, v2)
        print(f'Build took {(_time.perf_counter() - t0) * 1e3:.3f}ms',
              file=sys.stderr)
        print(f'BVH Size: {len(nodes.vmin)}', file=sys.stderr)
        perm = nodes.perm
        start = len(self._v0)
        self._v0 = np.concatenate([self._v0, v0[perm]])
        self._v1 = np.concatenate([self._v1, v1[perm]])
        self._v2 = np.concatenate([self._v2, v2[perm]])
        self._normal = np.concatenate([self._normal, normal[perm]])
        self._tangent = np.concatenate([self._tangent, tangent[perm]])
        self._bitangent = np.concatenate([self._bitangent, bitangent[perm]])
        self._uv = np.concatenate([self._uv, uv6[perm]])
        self._tri_mat = np.concatenate([self._tri_mat, tri_materials[perm]])
        # SBVH builds may reference a triangle from several leaves: perm then
        # holds n_refs >= nt entries. Mark 2nd+ occurrences so the light list
        # stays one-entry-per-source-triangle.
        n_refs = len(perm)
        if n_refs != nt:
            _, first = np.unique(perm, return_index=True)
            dup = np.ones(n_refs, bool)
            dup[first] = False
        else:
            dup = np.zeros(nt, bool)
        self._tri_dup = np.concatenate([self._tri_dup, dup])
        self.models.append(Model(start, n_refs, thread_bvh(nodes)))
        return len(self.models) - 1

    # ------------------------------------------------------------------
    def validate(self):
        assert len(self._v0) == len(self._tri_mat)

    def finalize(self):
        self.validate()
        if not self.materials:
            self.add_material(Material.DIFFUSE((0.4, 0.4, 0.4)))
        self._version += 1

    def instances(self):
        """Derive Instance transforms from GameObjects (ConvertToInstance,
        src/scene.h:9-25,364)."""
        n = max(len(self.objects), 0)
        transforms = np.zeros((n, 3, 4), np.float32)
        inverses = np.zeros((n, 3, 4), np.float32)
        overrides = np.full(n, NO_MATERIAL, np.int32)
        for i, obj in enumerate(self.objects):
            m = tf.object_transform(obj.position, obj.rotation, obj.scale)
            transforms[i] = tf.to_affine34(m)
            inverses[i] = tf.to_affine34(np.linalg.inv(m))
            overrides[i] = obj.material_id
        return transforms, inverses, overrides

    def update(self, keyboard=None, current_time: float = 0.0):
        """Per-frame host dynamics (src/scene.h:367-401): attach/move objects,
        run animation handlers, mark dynamic state dirty."""
        self.invalid = False
        if keyboard is not None:
            for i in range(10):
                if keyboard.is_pressed(f'attach_{i}'):
                    self.attached = i
            if 0 < self.attached <= len(self.objects):
                obj = self.objects[self.attached - 1]
                step = 0.04
                moves = {'move_left': (0, -step), 'move_right': (0, step),
                         'move_forward': (2, step), 'move_backward': (2, -step),
                         'move_up': (1, step), 'move_down': (1, -step)}
                for act, (axis, delta) in moves.items():
                    if keyboard.is_down(act):
                        obj.position[axis] += delta
                        self.invalidate()
                looks = {'look_left': (1, -step), 'look_right': (1, step),
                         'look_up': (0, -step), 'look_down': (0, step)}
                for act, (axis, delta) in looks.items():
                    if keyboard.is_down(act):
                        obj.rotation[axis] += delta
                        self.invalidate()
        for handler in self.handlers:
            handler(self, keyboard, current_time)
        if self.handlers:
            self._version += 1

    # ------------------------------------------------------------------
    # device export

    def extract_triangle_lights(self, overrides: np.ndarray):
        """Emissive-triangle extraction (src/pathtracer.h:154-170)."""
        tris, insts = [], []
        emis = np.array([m.emission for m in self.materials], np.float32) \
            if self.materials else np.zeros((0, 3), np.float32)
        for i, obj in enumerate(self.objects):
            model = self.models[obj.model_id]
            s, c = model.triangle_start, model.nr_triangles
            mat = self._tri_mat[s:s + c]
            if overrides[i] >= 0:
                mat = np.full(c, overrides[i], np.int32)
            em = emis[mat]
            sel = em.max(axis=1) >= EPS
            # SBVH duplicate refs must not multiply a light's pick weight
            sel &= ~self._tri_dup[s:s + c]
            idx = np.nonzero(sel)[0]
            tris.append(idx.astype(np.int32) + s)
            insts.append(np.full(len(idx), i, np.int32))
        if tris:
            return np.concatenate(tris), np.concatenate(insts)
        return np.zeros(0, np.int32), np.zeros(0, np.int32)

    def to_device(self, skydome: Optional[str] = None,
                  blue_noise: Optional[str] = None) -> SceneArrays:
        """Build the static SceneArrays (Pathtracer::Init's upload block,
        src/pathtracer.h:73-221)."""
        mats = self.materials or [Material.DIFFUSE((0.4, 0.4, 0.4))]

        def col(f):
            return jnp.asarray(np.array([f(m) for m in mats], np.float32))

        sky = None
        for cand in ([skydome] if skydome else []) + ['cave.hdr', 'skydome.jpg']:
            try:
                sky = load_image(self._resolve(cand))[..., :3]
                break
            except (FileNotFoundError, ValueError):
                continue
        if sky is None:
            sky = np.full((2, 4, 3), 0.5, np.float32)

        bn = None
        for cand in ([blue_noise] if blue_noise else []) + ['bluenoise.png']:
            try:
                bn = load_image(self._resolve(cand))[..., 0]
                break
            except FileNotFoundError:
                continue
        if bn is None:
            bn = np.linspace(0, 1, 64 * 64, dtype=np.float32).reshape(64, 64)

        transforms, inverses, overrides = self.instances()
        light_tri, light_inst = self.extract_triangle_lights(overrides)

        sp = self.spheres
        pl = self.planes
        pls = self.point_lights

        # ---- packed single-gather rows ----
        def _i2f(a):
            return np.asarray(a, np.int32).view(np.float32)

        M = len(mats)
        mat_packed = np.zeros((M, 24), np.float32)
        for i, m in enumerate(mats):
            mat_packed[i, 0:3] = m.diffuse_color
            mat_packed[i, 3:6] = m.specular_color
            mat_packed[i, 6:9] = m.emission
            mat_packed[i, 9] = m.reflect
            mat_packed[i, 10] = m.glossy
            mat_packed[i, 11] = m.transmit
            mat_packed[i, 12] = m.refractive_index
            mat_packed[i, 13:16] = m.absorption
            mat_packed[i, 16] = _i2f([m.texture])[0]
            mat_packed[i, 17] = _i2f([m.normal_texture])[0]

        T = len(self._tri_mat)
        tri_packed = np.zeros((T, 16), np.float32)
        tri_packed[:, 0:3] = self._normal
        tri_packed[:, 3:6] = self._tangent
        tri_packed[:, 6:9] = self._bitangent
        tri_packed[:, 9:15] = self._uv
        tri_packed[:, 15] = _i2f(self._tri_mat)

        sphere_packed = np.zeros((len(sp), 8), np.float32)
        for i, s in enumerate(sp):
            sphere_packed[i, 0:3] = s.pos
            sphere_packed[i, 3] = s.radius
            sphere_packed[i, 4] = _i2f([s.material])[0]
        plane_packed = np.zeros((len(pl), 8), np.float32)
        for i, p in enumerate(pl):
            plane_packed[i, 0:3] = p.normal
            plane_packed[i, 3] = p.d
            plane_packed[i, 4] = _i2f([p.material])[0]

        return SceneArrays(
            tri_normal=jnp.asarray(self._normal),
            tri_tangent=jnp.asarray(self._tangent),
            tri_bitangent=jnp.asarray(self._bitangent),
            tri_uv=jnp.asarray(self._uv),
            tri_mat=jnp.asarray(self._tri_mat),
            mat_diffuse=col(lambda m: m.diffuse_color),
            mat_specular=col(lambda m: m.specular_color),
            mat_emission=col(lambda m: m.emission),
            mat_reflect=col(lambda m: m.reflect),
            mat_glossy=col(lambda m: m.glossy),
            mat_transmit=col(lambda m: m.transmit),
            mat_ior=col(lambda m: m.refractive_index),
            mat_absorption=col(lambda m: m.absorption),
            mat_tex=jnp.asarray(np.array([m.texture for m in mats], np.int32)),
            mat_normal_tex=jnp.asarray(
                np.array([m.normal_texture for m in mats], np.int32)),
            textures=self.atlas.build(),
            sphere_pos=jnp.asarray(np.array([s.pos for s in sp], np.float32).reshape(-1, 3)),
            sphere_radius=jnp.asarray(np.array([s.radius for s in sp], np.float32)),
            sphere_mat=jnp.asarray(np.array([s.material for s in sp], np.int32)),
            plane_normal=jnp.asarray(np.array([p.normal for p in pl], np.float32).reshape(-1, 3)),
            plane_d=jnp.asarray(np.array([p.d for p in pl], np.float32)),
            plane_mat=jnp.asarray(np.array([p.material for p in pl], np.int32)),
            point_light_pos=jnp.asarray(np.array([l.pos for l in pls], np.float32).reshape(-1, 3)),
            point_light_color=jnp.asarray(np.array([l.color for l in pls], np.float32).reshape(-1, 3)),
            light_tri=jnp.asarray(light_tri),
            light_inst=jnp.asarray(light_inst),
            sky_img=jnp.asarray(sky),
            sky_pairs=jnp.asarray(_sky_mod.build_sky_pairs(sky)),
            blue_noise=jnp.asarray(bn),
            mat_packed=jnp.asarray(mat_packed),
            tri_packed=jnp.asarray(tri_packed),
            sphere_packed=jnp.asarray(sphere_packed),
            plane_packed=jnp.asarray(plane_packed),
            nmap_marker=jnp.zeros(
                (int(any(m.normal_texture >= 0 for m in mats)),), jnp.float32),
        )

    def _structure_key(self):
        """Scene topology fingerprint: while unchanged, invalidations can use
        the device-side refit instead of a full host rebuild."""
        return (len(self.models),
                tuple(o.model_id for o in self.objects),
                tuple(int(o.material_id) for o in self.objects))

    def dynamic_arrays(self) -> DynamicArrays:
        """Instances + merged world BVH, cached until invalidation
        (the analogue of the instance/top-BVH refresh at
        src/pathtracer.h:245-246). After the first full build, invalidations
        that only MOVE things (animation handlers, attached-object motion)
        take the device refit path: host work is the instance matrices plus
        the few top rows (accel/refit.py), mirroring the reference's
        cheap per-frame update (src/pathtracer.h:245-246, scene.h:400)."""
        if self._dyn_cache is not None and self._dyn_cache[0] == self._version:
            return self._dyn_cache[1]
        if (self._refit_templates is not None
                and self._refit_key == self._structure_key()):
            dyn = self._refit_dynamic_arrays()
            self._dyn_cache = (self._version, dyn)
            return dyn
        transforms, inverses, overrides = self.instances()
        if self.objects:
            wb = build_world_bvh(
                [m.bvh for m in self.models],
                [m.triangle_start for m in self.models],
                [m.nr_triangles for m in self.models],
                self._v0, self._v1, self._v2,
                np.array([o.model_id for o in self.objects], np.int32),
                transforms)
            depth = inner_ancestors(wb.miss, wb.leaf_count)
            if depth > TRAVERSE_STACK:
                raise ValueError(
                    f'world BVH has {depth} nested inner nodes; the GPU '
                    f'traversal stack holds {TRAVERSE_STACK}')
            world = WorldArrays.from_host(wb)
        else:
            world = WorldArrays(
                node_box=jnp.zeros((0, 6), jnp.float32),
                node_meta=jnp.zeros((0, 3), jnp.int32),
                tris=jnp.zeros((0, 9), jnp.float32),
                tri_gid=jnp.zeros((0,), jnp.int32),
                tri_inst=jnp.zeros((0,), jnp.int32))
        lv0, lv1, lv2, lnrm, lemis, light_packed = \
            self._light_arrays(transforms, overrides)

        if self.objects:
            # capture the model-space templates so later move-only
            # invalidations refit on DEVICE (accel/refit.py)
            from ..accel import refit as _refit
            self._refit_templates = _refit.build_templates(
                wb, self._v0, self._v1, self._v2)
            self._refit_key = self._structure_key()
        else:
            self._refit_templates = None
            self._refit_key = None

        inst_packed = self._inst_packed(transforms, overrides)
        if self.objects:
            # stored as float VALUES (< 2^24 exact), not int, so one f32
            # row gather serves every column. Cols 2:11 embed the
            # WORLD-SPACE triangle verts (the same v0|v1|v2 as world.tris).
            assert len(wb.tri_gid) < (1 << 24), 'gid exceeds f32 exactness'
            # Cols 11:27 bake the per-triangle SHADE attributes (the same
            # values tri_packed[gid] holds, pre-gathered per world tri):
            # shade then reads everything except the guiding-cache row off
            # THIS one gather. All attrs are model-space (normals/tangents
            # transform in shade by inst_tf), so refit leaves cols 11:
            # untouched.
            tri_meta = np.zeros((len(wb.tri_gid), 32), np.float32)
            tri_meta[:, 0] = wb.tri_gid
            tri_meta[:, 1] = wb.tri_inst
            tri_meta[:, 2:5] = wb.tri_v0
            tri_meta[:, 5:8] = wb.tri_v1
            tri_meta[:, 8:11] = wb.tri_v2
            g = np.asarray(wb.tri_gid, np.int64)
            tri_meta[:, 11:14] = self._normal[g]
            tri_meta[:, 14:17] = self._tangent[g]
            tri_meta[:, 17:20] = self._bitangent[g]
            tri_meta[:, 20:26] = self._uv[g]
            tri_meta[:, 26] = np.asarray(self._tri_mat,
                                         np.int32).view(np.float32)[g]
        else:
            tri_meta = np.zeros((0, 32), np.float32)

        # per-instance world-tri block map for shade's arithmetic
        # pid -> (gid, inst) decode (see DynamicArrays.tri_blocks)
        if self.objects:
            bases = np.asarray(wb.wtri_base, np.int64)
            starts = np.array([self.models[o.model_id].triangle_start
                               for o in self.objects], np.int64)
            order = np.argsort(bases, kind='stable')
            tri_blocks = np.stack(
                [bases[order], order.astype(np.int64),
                 starts[order] - bases[order]], axis=1).astype(np.float32)
        else:
            tri_blocks = np.zeros((0, 3), np.float32)

        dyn = DynamicArrays(world,
                            jnp.asarray(transforms), jnp.asarray(inverses),
                            jnp.asarray(overrides),
                            jnp.asarray(lv0, jnp.float32),
                            jnp.asarray(lv1, jnp.float32),
                            jnp.asarray(lv2, jnp.float32),
                            jnp.asarray(lnrm, jnp.float32),
                            jnp.asarray(lemis, jnp.float32),
                            kernel_tables(world),
                            jnp.asarray(light_packed),
                            jnp.asarray(inst_packed),
                            jnp.asarray(tri_meta),
                            jnp.asarray(tri_blocks))
        self._dyn_cache = (self._version, dyn)
        self._full_dyn = dyn
        return dyn

    def _light_arrays(self, transforms, overrides):
        """World-space emissive light triangles (the DTriangleLights of
        pathtracer.h:154-170, pre-transformed so shading never gathers
        instance matrices for NEE). Host work is O(light triangles) — tiny."""
        light_tri, light_inst = self.extract_triangle_lights(overrides)
        if len(light_tri):
            lt = transforms[light_inst]                     # [TL, 3, 4]
            rot = lt[:, :, :3]
            trn = lt[:, :, 3]
            lv0 = np.einsum('lij,lj->li', rot, self._v0[light_tri]) + trn
            lv1 = np.einsum('lij,lj->li', rot, self._v1[light_tri]) + trn
            lv2 = np.einsum('lij,lj->li', rot, self._v2[light_tri]) + trn
            lnrm = np.einsum('lij,lj->li', rot, self._normal[light_tri])
            lnrm /= np.maximum(np.linalg.norm(lnrm, axis=1, keepdims=True),
                               1e-30)
            lmat = np.where(overrides[light_inst] >= 0, overrides[light_inst],
                            self._tri_mat[light_tri])
            emis = np.array([m.emission for m in self.materials], np.float32)
            lemis = emis[lmat]
        else:
            lv0 = lv1 = lv2 = lnrm = lemis = np.zeros((0, 3), np.float32)
        tl = len(lv0)
        light_packed = np.zeros((tl, 16), np.float32)
        if tl:
            light_packed[:, 0:3] = lv0
            light_packed[:, 3:6] = lv1
            light_packed[:, 6:9] = lv2
            light_packed[:, 9:12] = lnrm
            light_packed[:, 12:15] = lemis
        return lv0, lv1, lv2, lnrm, lemis, light_packed

    def _inst_packed(self, transforms, overrides):
        n_inst = len(self.objects)
        inst_packed = np.zeros((n_inst, 16), np.float32)
        if n_inst:
            inst_packed[:, 0:12] = transforms.reshape(n_inst, 12)
            inst_packed[:, 12] = np.asarray(overrides,
                                            np.int32).view(np.float32)
        return inst_packed

    def _refit_dynamic_arrays(self) -> DynamicArrays:
        """Move-only invalidation: instance matrices + top rows on the host,
        everything else transformed on device (accel/refit.py)."""
        from ..accel import refit as _refit
        from ..core import transforms as _tf
        transforms, inverses, overrides = self.instances()
        inst_boxes = np.empty((len(self.objects), 6), np.float32)
        for i, o in enumerate(self.objects):
            mb = self.models[o.model_id].bvh
            mn, mx = _tf.transform_box(mb.vmin[0], mb.vmax[0], transforms[i])
            inst_boxes[i, 0:3] = mn
            inst_boxes[i, 3:6] = mx
        node_box, wtris = _refit.refit_all(
            self._refit_templates, transforms, inst_boxes)
        lv0, lv1, lv2, lnrm, lemis, light_packed = \
            self._light_arrays(transforms, overrides)
        base = self._full_dyn
        world = base.world._replace(node_box=node_box, tris=wtris)
        # tri_meta embeds the world verts in cols 2:11 (see _dynamic_arrays)
        # — refresh them from the refitted wtris on device (one concat)
        tri_meta = jnp.concatenate(
            [base.tri_meta[:, :2], wtris, base.tri_meta[:, 11:]], axis=1)
        return base._replace(
            world=world,
            tri_meta=tri_meta,
            inst_transform=jnp.asarray(transforms),
            inst_inv=jnp.asarray(inverses),
            inst_mat=jnp.asarray(overrides),
            light_v0w=jnp.asarray(lv0, jnp.float32),
            light_v1w=jnp.asarray(lv1, jnp.float32),
            light_v2w=jnp.asarray(lv2, jnp.float32),
            light_normal_w=jnp.asarray(lnrm, jnp.float32),
            light_emission_w=jnp.asarray(lemis, jnp.float32),
            kernel=kernel_tables(world),
            light_packed=jnp.asarray(light_packed),
            inst_packed=jnp.asarray(self._inst_packed(transforms, overrides)))
