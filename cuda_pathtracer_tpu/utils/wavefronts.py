"""The three wavefront kinds of a frame, for checking and timing traversal at
real widths: primary camera rays, bounce-1 rays leaving the primary hits,
and NEE shadow rays from light samples back to those hits.

The bounce and shadow batches are built from the primary hits found by the
XLA reference traversal (ops/traverse.py), so every traversal path is fed
the same rays.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import EPS, T_MAX
from ..core import camera as cam_mod
from ..core import rng as _rng
from ..core import vecmath as vm
from ..ops.traverse import PRIM_TRIANGLE, traverse


def _unit(key, n):
    v = jax.random.normal(key, (n, 3), jnp.float32)
    return vm.normalize(v, eps=1e-12)


@jax.jit
def _build(arrays, dyn, camera_ro, camera_rd, key):
    n = camera_ro.shape[0]
    hit = traverse(arrays, dyn.world, camera_ro, camera_rd)
    on_tri = hit.intersected & (hit.prim_type == PRIM_TRIANGLE)
    tri = dyn.world.tris[jnp.clip(hit.prim_id, 0, dyn.world.tris.shape[0] - 1)]
    nrm = vm.normalize(vm.cross(tri[:, 3:6] - tri[:, 0:3],
                                tri[:, 6:9] - tri[:, 0:3]), eps=1e-12)
    nrm = jnp.where((vm.dot(nrm, camera_rd) > 0)[:, None], -nrm, nrm)
    pos = camera_ro + hit.t[:, None] * camera_rd

    k_dir, k_light, k_bary = jax.random.split(key, 3)
    # bounce 1: cosine-weighted about the surface normal
    d1 = vm.normalize(nrm + _unit(k_dir, n), eps=1e-12)
    o1 = pos + EPS * nrm

    # shadow: from a point on a random emissive triangle (or the first point
    # light) to the hit point, inverted like the engine's NEE connect
    n_tl = dyn.light_v0w.shape[0]
    if n_tl:
        li = jax.random.randint(k_light, (n,), 0, n_tl)
        ab = jax.random.uniform(k_bary, (n, 2))
        a = jnp.sqrt(ab[:, 0:1])
        lp = ((1 - a) * dyn.light_v0w[li] + a * (1 - ab[:, 1:2])
              * dyn.light_v1w[li] + a * ab[:, 1:2] * dyn.light_v2w[li])
    else:
        lp = jnp.broadcast_to(arrays.point_light_pos[0], (n, 3))
    to_hit = o1 - lp
    dist = vm.length(to_hit)
    ds = to_hit / jnp.maximum(dist, 1e-12)[:, None]
    return dict(
        primary=(camera_ro, camera_rd, jnp.full((n,), T_MAX, jnp.float32),
                 jnp.ones((n,), bool)),
        bounce=(o1, d1, jnp.full((n,), T_MAX, jnp.float32), on_tri),
        shadow=(lp, ds, dist - EPS, on_tri))


def wavefronts(arrays, dyn, camera, width: int, height: int, seed: int = 0):
    """{kind: (ro, rd, t_max, active)} for kind in primary, bounce, shadow;
    width * height rays each. Primary rays are jittered within their pixel
    as the engine's are (pixel centres would line up with the grid edges of
    the procedural meshes). Shadow rays are traced any-hit."""
    ys, xs = np.mgrid[0:height, 0:width]
    xs = jnp.asarray(xs.ravel(), jnp.int32)
    ys = jnp.asarray(ys.ravel(), jnp.int32)
    ro, rd, _ = cam_mod.generate_rays(
        camera, xs, ys, _rng.get_seed(xs, ys, seed, width), width, height)
    return _build(arrays, dyn, ro, rd, jax.random.PRNGKey(seed))
