"""Hemisphere sampling library (vectorized mirror of src/kernels.h:390-450).

All samplers draw from the lane-wise RNG (core/rng.py) through `masked_rand`,
which advances a lane's stream only where that lane actually takes the branch —
this reproduces the reference's per-thread draw sequences exactly even though
every branch is computed for every lane (select-based SIMT).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core import rng as _rng
from ..core import vecmath as vm
from ..constants import PI, EPS, GUIDE_BUCKETS


def masked_rand(state: _rng.RandState, mask):
    """Draw for every lane but only advance the stream where `mask` is true."""
    val, new = _rng.rand(state)
    merged = _rng.RandState(
        seed=jnp.where(mask, new.seed, state.seed),
        bn_sample=state.bn_sample,
        bn_idx=jnp.where(mask, new.bn_idx, state.bn_idx),
        sample_idx=state.sample_idx)
    return val, merged


def _to_world(sample, w):
    """Rotate a tangent-space sample to align +z with `w` using the
    reference's basis construction (src/kernels.h:398-405)."""
    u, v = vm.orthonormal_basis(w)
    # rows of the rotation are (u.x, v.x, w.x) etc. — matches the explicit
    # dot products in SampleHemisphereCosine
    return vm.normalize(
        sample[..., 0:1] * u + sample[..., 1:2] * v + sample[..., 2:3] * w)


def hemisphere_cosine(normal, r0, r1):
    """Cosine-weighted hemisphere sample (src/kernels.h:390-406)."""
    r = jnp.sqrt(r0)
    theta = 2.0 * PI * r1
    sample = jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta),
                        jnp.sqrt(jnp.maximum(1.0 - r0, 0.0))], axis=-1)
    return _to_world(sample, normal)


def hemisphere_uniform(normal, u1, u2):
    """Uniform hemisphere sample (src/kernels.h:434-450)."""
    r = jnp.sqrt(jnp.maximum(1.0 - u1 * u1, 0.0))
    phi = 2.0 * PI * u2
    sample = jnp.stack([jnp.cos(phi) * r, jnp.sin(phi) * r, u1], axis=-1)
    return _to_world(sample, normal)


def hemisphere_cached(normal, radiance_cache, radiance_total,
                      s_pick, r0_raw, r1_raw):
    """Guided sample over the 8-bucket radiance cache
    (SampleHemisphereCached, src/kernels.h:408-431).

    radiance_cache: f32[..., 8]; radiance_total: f32[...]
    s_pick/r0_raw/r1_raw: the three uniform draws, in reference order.
    Returns (direction, bucket i32, invprob).
    """
    cols = [radiance_cache[..., j] for j in range(GUIDE_BUCKETS)]
    return hemisphere_cached_cols(normal, cols, radiance_total,
                                  s_pick, r0_raw, r1_raw)


def hemisphere_cached_cols(normal, cols, radiance_total,
                           s_pick, r0_raw, r1_raw):
    """hemisphere_cached over 8 SEPARATE column vectors.

    The [L,8] array form made XLA lay the CDF walk out column-major
    ({0,1}) and REMATERIALIZE the cache-row gather from the raw [T,8]
    table to feed it. Unrolling the walk into per-column [L] arithmetic
    keeps every tensor lane-major and the only cache read is the merged
    24-col row gather. Bit-identical: the unrolled prefix adds ARE cumsum's
    sequential order, and the masked picks are the same one-hot sums.
    """
    sample = s_pick * radiance_total
    # do-while: bucket = first index where EPS + cumsum >= sample
    run = jnp.zeros(cols[0].shape, jnp.float32)
    bucket = jnp.zeros(cols[0].shape, jnp.int32)
    for j in range(GUIDE_BUCKETS):
        run = run + cols[j]
        bucket = bucket + ((run + EPS) < sample).astype(jnp.int32)
    bucket = jnp.minimum(bucket, GUIDE_BUCKETS - 1)

    bf = bucket.astype(jnp.float32)
    r0_min = jnp.where(bucket < 4, 0.0, 0.5)
    r0_max = jnp.where(bucket < 4, 0.5, 1.0)
    r1i = jnp.mod(bf, 4.0)
    r1_min = r1i * 0.25
    r1_max = (r1i + 1.0) * 0.25
    # note the reference's inverted lerp: min*t + max*(1-t)
    r0 = r0_min * r0_raw + r0_max * (1.0 - r0_raw)
    r1 = r1_min * r1_raw + r1_max * (1.0 - r1_raw)

    # one-hot select instead of take_along_axis (a per-lane gather); exactly
    # one term of the masked sum is nonzero, so this is bit-exact
    picked = jnp.zeros(cols[0].shape, jnp.float32)
    for j in range(GUIDE_BUCKETS):
        picked = picked + jnp.where(bucket == j, cols[j], 0.0)
    invprob = radiance_total / (picked * GUIDE_BUCKETS)
    return hemisphere_cosine(normal, r0, r1), bucket, invprob
