"""The guiding bucket sums (models/guiding.accumulate_buckets, one
`jax.ops.segment_sum`) against an f64 `np.add.at` reference of
kernel_update_buckets (src/kernels.h:863-882).

Covers the shapes the guiding update produces (dense low segments, invalid
entries routed to a dump segment) and adversarial distributions: sparse
spans over a large table, heavy duplication on a tiny table, all-one-segment
streams and sub-block inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_pathtracer_tpu.constants import GUIDE_BUCKETS, MAX_CACHE_DEPTH
from cuda_pathtracer_tpu.models import guiding
from cuda_pathtracer_tpu.models.guiding import (SampleCache, SAMPLE_BUCKET,
                                                SAMPLE_IGNORE,
                                                SAMPLE_TERMINATE)


def _reference(n_tris, stype, tri, bucket, cum, energy_rgb):
    """f64 per-(triangle, bucket) energy sums and counts."""
    term = stype == SAMPLE_TERMINATE
    alive_chain = np.cumsum(term, axis=0) - term
    valid = (stype == SAMPLE_BUCKET) & (alive_chain == 0)
    ratio = energy_rgb[None].astype(np.float64) / cum.astype(np.float64)
    lum = 0.299 * ratio[..., 0] + 0.587 * ratio[..., 1] + 0.114 * ratio[..., 2]
    energy = np.fmin(guiding.ENERGY_CLAMP, lum)
    seg = (tri * GUIDE_BUCKETS + bucket)[valid]
    sums = np.zeros(n_tris * GUIDE_BUCKETS)
    counts = np.zeros(n_tris * GUIDE_BUCKETS)
    np.add.at(sums, seg, energy[valid])
    np.add.at(counts, seg, 1.0)
    return (sums.reshape(n_tris, GUIDE_BUCKETS),
            counts.reshape(n_tris, GUIDE_BUCKETS))


def _check(n_tris, stype, tri, bucket, cum, energy_rgb):
    cache = SampleCache(jnp.asarray(stype, jnp.int32),
                        jnp.asarray(tri, jnp.int32),
                        jnp.asarray(bucket, jnp.int32),
                        jnp.asarray(cum, jnp.float32))
    got_e, got_w = guiding.accumulate_buckets(
        n_tris, cache, jnp.asarray(energy_rgb, jnp.float32))
    want_e, want_w = _reference(n_tris, stype, tri, bucket, cum, energy_rgb)
    np.testing.assert_allclose(np.asarray(got_e), want_e, rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(np.asarray(got_w), want_w)


def _random_cache(rng, lanes, n_tris, p_bucket=0.7, tri_hi=None):
    shape = (MAX_CACHE_DEPTH, lanes)
    u = rng.random(shape)
    stype = np.where(u < p_bucket, SAMPLE_BUCKET,
                     np.where(u < p_bucket + 0.15, SAMPLE_IGNORE,
                              SAMPLE_TERMINATE))
    tri = rng.integers(0, tri_hi or n_tris, shape)
    bucket = rng.integers(0, GUIDE_BUCKETS, shape)
    cum = rng.uniform(0.05, 1.0, shape + (3,))
    energy = rng.uniform(0.0, 20.0, (lanes, 3))
    return stype, tri, bucket, cum, energy


@pytest.mark.parametrize('L,S,seed', [
    (3000, 512, 0),        # dense: most buckets hit several times
    (2048, 37_500, 1),     # sparse: updates spread over a large table
    (1024, 16, 2),         # heavy duplication, tiny table
    (700, 256, 3),         # sub-block input
])
def test_matches_segment_sum(L, S, seed):
    rng = np.random.default_rng(seed)
    _check(S, *_random_cache(rng, L, S))


def test_single_segment_stream():
    # every valid update in one (triangle, bucket): one run the length of
    # the stream
    L, n_tris = 2048, 1125
    stype = np.full((MAX_CACHE_DEPTH, L), SAMPLE_BUCKET)
    tri = np.full((MAX_CACHE_DEPTH, L), n_tris - 1)
    bucket = np.full((MAX_CACHE_DEPTH, L), GUIDE_BUCKETS - 1)
    cum = np.ones((MAX_CACHE_DEPTH, L, 3))
    energy = np.ones((L, 3))
    _check(n_tris, stype, tri, bucket, cum, energy)


def test_guiding_shape_distribution():
    # the real update shape: valid entries hit a few hundred triangles'
    # buckets, the rest are terminated or ignored chains
    rng = np.random.default_rng(7)
    _check(2000, *_random_cache(rng, 6144, 2000, p_bucket=0.6, tri_hi=300))
