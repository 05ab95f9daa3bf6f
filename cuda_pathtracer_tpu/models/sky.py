"""Equirect skydome: direction<->uv mapping, bilinear sampling, energy CDF.

Mirrors normalToUv/uvToNormal (src/kernels.h:31-49) and the skydome CDF built
in Pathtracer::Init (src/pathtracer.h:85-122). Like the reference, the CDF is
constructed and carried but not importance-sampled by the shader (path guiding
superseded it, reference README.md:55); it is exposed for completeness and for
the importance-sampling tests.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..constants import PI


def normal_to_uv(n):
    """src/kernels.h:31-36; uv may be negative — wrap handles it."""
    theta = jnp.arctan2(n[..., 0], n[..., 2]) / (2.0 * PI)
    phi = -jnp.arccos(jnp.clip(n[..., 1], -1.0, 1.0)) / PI
    return theta, phi


def uv_to_normal(u, v):
    """src/kernels.h:39-49."""
    theta = u * 2.0 * PI
    phi = -v * PI
    return jnp.stack([jnp.sin(theta) * jnp.sin(phi),
                      jnp.cos(phi),
                      jnp.cos(theta) * jnp.sin(phi)], axis=-1)


def sample_sky(sky_img, direction):
    """Bilinear wrap-addressed fetch of the equirect skydome for escaped rays
    (kernel_shade's miss branch, src/kernels.h:526-537)."""
    u, v = normal_to_uv(direction)
    h, w = sky_img.shape[0], sky_img.shape[1]
    fu = u * w - 0.5
    fv = v * h - 0.5
    x0 = jnp.floor(fu)
    y0 = jnp.floor(fv)
    tx = (fu - x0)[..., None]
    ty = (fv - y0)[..., None]

    # ONE batched gather for all four bilinear corners instead of four
    # separate gather dispatches
    def flat(xi, yi):
        xi = jnp.mod(xi.astype(jnp.int32), w)
        yi = jnp.mod(yi.astype(jnp.int32), h)
        return yi * w + xi
    idx4 = jnp.stack([flat(x0, y0), flat(x0 + 1, y0),
                      flat(x0, y0 + 1), flat(x0 + 1, y0 + 1)])
    c = sky_img.reshape(-1, sky_img.shape[-1])[idx4]
    c00, c10, c01, c11 = c[0], c[1], c[2], c[3]
    return ((c00 * (1 - tx) + c10 * tx) * (1 - ty)
            + (c01 * (1 - tx) + c11 * tx) * ty)


def build_sky_pairs(sky_img: np.ndarray) -> np.ndarray:
    """Horizontal texel-pair table [H*W, 6]: row (y*W + x) holds
    texel(x, y) ++ texel((x+1) mod W, y). Bilinear sampling then needs TWO
    row gathers (bottom pair + top pair) instead of four corner rows, for
    the price of a duplicated skydome in device memory. (A 12-wide QUAD
    table was laid out column-major by XLA for this consumer shape, so each
    row fetch became 12 strided reads; the [2, B]-indexed pair form keeps
    the row-contiguous layout.)"""
    img = np.asarray(sky_img, np.float32)
    pairs = np.concatenate([img, np.roll(img, -1, axis=1)], axis=-1)
    return pairs.reshape(-1, 2 * img.shape[-1])


def sample_sky_pairs(sky_pairs, shape, direction, live=None):
    """Bilinear skydome fetch from the pair table (bit-identical to
    sample_sky: same corner texels, same lerp).

    `live` masks lanes whose result the caller will consume: dead lanes
    gather row 0 instead of a direction-dependent random row. The sky pair
    table is the biggest gather table in the engine (27 MB for a 1500x750
    HDR dome), and on the bounce shade nearly every lane hits a wall and is
    masked out anyway."""
    h, w = shape
    u, v = normal_to_uv(direction)
    fu = u * w - 0.5
    fv = v * h - 0.5
    x0 = jnp.floor(fu)
    y0 = jnp.floor(fv)
    tx = (fu - x0)[..., None]
    ty = (fv - y0)[..., None]
    xi = jnp.mod(x0.astype(jnp.int32), w)
    y0i = jnp.mod(y0.astype(jnp.int32), h)
    y1i = jnp.mod(y0.astype(jnp.int32) + 1, h)
    idx2 = jnp.stack([y0i * w + xi, y1i * w + xi])
    if live is not None:
        idx2 = jnp.where(live, idx2, 0)
    rows = sky_pairs[idx2]                       # [2, ..., 6]
    c00, c10 = rows[0][..., 0:3], rows[0][..., 3:6]
    c01, c11 = rows[1][..., 0:3], rows[1][..., 3:6]
    return ((c00 * (1 - tx) + c10 * tx) * (1 - ty)
            + (c01 * (1 - tx) + c11 * tx) * ty)


def build_sky_cdf(sky_img: np.ndarray):
    """Per-pixel max-component energy CDF (src/pathtracer.h:85-119).
    Returns (values, cum_values) both normalized by total energy."""
    energy = np.max(np.asarray(sky_img, np.float32), axis=-1).reshape(-1)
    total = float(energy.sum())
    if total <= 0:
        total = 1.0
    cum = np.cumsum(energy)
    return energy / total, (cum / total).astype(np.float32)


def sample_sky_cdf(cum_values, sky_shape, r):
    """Inverse-CDF pick of a skydome texel -> (u, v, pdf-normalized index).
    Binary search equivalent of src/kernels.h:65-79 via searchsorted."""
    idx = jnp.searchsorted(cum_values, r)
    idx = jnp.clip(idx, 0, cum_values.shape[0] - 1)
    h, w = sky_shape
    y = idx // w
    x = jnp.mod(idx, w)
    u = (x.astype(jnp.float32) + 0.5) / w
    v = (y.astype(jnp.float32) + 0.5) / h
    return u, v, idx
