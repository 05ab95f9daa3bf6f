"""Device-side per-frame refit of the world acceleration structures.

The reference refreshes only instance matrices and the tiny top-level BVH per
invalidation (src/pathtracer.h:245-246, src/scene.h:400); bottom BVHs and
triangles never leave the device. This module is the equivalent here: the
spliced world tables are built ONCE in model space (identity transforms) as
templates resident in device memory, and every invalidation runs one jitted
refit —
pure einsum/elementwise work over the tables — instead of re-baking every
world triangle in numpy and re-uploading tens of MB.

What moves per invalidation: the instance transforms (I x 12 floats) and the
world box. Everything else is compute on data already on the device.

Splice topology (node links, gids, leaf counts) is FROZEN at template build;
animation changes geometry only.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# f32 products in full f32: a box refitted in TF32 may not enclose its
# triangles, and traversal would then miss hits
_HIGHEST = jax.lax.Precision.HIGHEST

# 8 box corners as min/max selectors
_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
                     [1, 1, 1], [0, 1, 1], [1, 0, 1], [1, 1, 0]], np.float32)


class RefitTemplates(NamedTuple):
    """Model-space threaded world BVH geometry + per-row owners (built once
    per scene topology)."""
    node_box: jnp.ndarray     # f32[N, 6]
    node_inst: jnp.ndarray    # i32[N]
    tris: jnp.ndarray         # f32[WT, 9]
    tri_inst: jnp.ndarray     # i32[WT]


def _gather_tf(transforms, inst):
    """transforms: f32[I+1, 3, 4] (last row = identity for inst == -1)."""
    idx = jnp.where(inst < 0, transforms.shape[0] - 1, inst)
    return transforms[idx]                      # [R, 3, 4]


@jax.jit
def _refit_world(node_box, node_inst, tris, tri_inst, transforms, world_box):
    """Threaded world BVH geometry refit. The handful of top pairing nodes
    (node_inst == -1) get the whole world box — conservative and correct
    (they are always entered), trading a few extra node visits for a frozen
    topology."""
    tf = _gather_tf(transforms, node_inst)
    rot, trn = tf[:, :, :3], tf[:, :, 3]
    vmin, vmax = node_box[:, 0:3], node_box[:, 3:6]
    corners = (vmin[:, None, :] * (1 - _CORNERS)
               + vmax[:, None, :] * _CORNERS)            # [N, 8, 3]
    wc = jnp.einsum('rij,rgj->rgi', rot, corners,
                    precision=_HIGHEST) + trn[:, None, :]
    nb = jnp.concatenate([jnp.min(wc, axis=1), jnp.max(wc, axis=1)], axis=1)
    nb = jnp.where((node_inst < 0)[:, None], world_box[None, :], nb)

    tft = _gather_tf(transforms, tri_inst)
    rott, trnt = tft[:, :, :3], tft[:, :, 3]
    tv = tris.reshape(-1, 3, 3)
    wt = jnp.einsum('rij,rvj->rvi', rott, tv,
                    precision=_HIGHEST) + trnt[:, None, :]
    return nb, wt.reshape(-1, 9)


def build_templates(wb, tri_v0, tri_v1, tri_v2) -> 'RefitTemplates':
    """Capture the model-space world tables once per scene topology: node
    boxes from the world build's model-space boxes, triangles from the
    model-space vertices of their source triangles."""
    tris_model = np.concatenate(
        [tri_v0[wb.tri_gid], tri_v1[wb.tri_gid], tri_v2[wb.tri_gid]],
        axis=1).astype(np.float32)
    node_box = np.concatenate([wb.mvmin, wb.mvmax], axis=1).astype(np.float32)
    return RefitTemplates(
        node_box=jnp.asarray(node_box),
        node_inst=jnp.asarray(wb.node_inst),
        tris=jnp.asarray(tris_model),
        tri_inst=jnp.asarray(wb.tri_inst))


def refit_all(templates: RefitTemplates, transforms: np.ndarray,
              inst_root_boxes: np.ndarray):
    """One invalidation on the device. inst_root_boxes: f32[I, 6] world boxes
    of the instance roots (their union boxes the top pairing nodes). Returns
    (node_box, world_tris)."""
    ident = np.hstack([np.eye(3, dtype=np.float32),
                       np.zeros((3, 1), np.float32)])
    t34 = jnp.asarray(np.concatenate(
        [transforms.astype(np.float32), ident[None]], axis=0))
    wmin = inst_root_boxes[:, 0:3].min(axis=0)
    wmax = inst_root_boxes[:, 3:6].max(axis=0)
    world_box = jnp.asarray(np.concatenate([wmin, wmax]).astype(np.float32))
    return _refit_world(templates.node_box, templates.node_inst,
                         templates.tris, templates.tri_inst, t34, world_box)
