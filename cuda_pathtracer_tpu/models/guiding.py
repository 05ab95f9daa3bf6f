"""Path guiding: the 8-bucket per-triangle radiance cache.

The atomicAdd update/propagate kernels (kernel_update_buckets /
kernel_propagate_buckets, src/kernels.h:848-905) become one `segment_sum`
keyed by triangle_id * 8 + bucket and a pure elementwise EMA propagate — no
concurrency control in user code (the reference needed a dedicated
per-triangle kernel for that, README.md:91-92).

Semantics preserved: energy = min(100, luminance(totalEnergy / cum_mask)),
EMA alpha = 0.95, clamp to [0.1, 2.0], radianceTotal tracks the bucket sum,
initial value 0.1 per bucket (kernel_init_radiance_cache, kernels.h:848-861).
A TERMINATE entry stops a pixel's chain; IGNORE skips a bounce but continues
(kernel_update_buckets, kernels.h:870-880).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import vecmath as vm
from ..constants import EPS, GUIDE_BUCKETS, MAX_CACHE_DEPTH

# sample-cache entry types (SAMPLE_TYPE, src/types.h:337)
SAMPLE_IGNORE = 0
SAMPLE_TERMINATE = 1
SAMPLE_BUCKET = 2

ALPHA = 0.95
ENERGY_CLAMP = 100.0
VALUE_MIN = 0.1
VALUE_MAX = 2.0


class RadianceState(NamedTuple):
    cache: jnp.ndarray  # f32[T, 8]
    total: jnp.ndarray  # f32[T]


def init_radiance_state(num_triangles: int) -> RadianceState:
    cache = jnp.full((num_triangles, GUIDE_BUCKETS), VALUE_MIN, jnp.float32)
    return RadianceState(cache, jnp.full((num_triangles,),
                                         GUIDE_BUCKETS * VALUE_MIN, jnp.float32))


class SampleCache(NamedTuple):
    """Per-bounce guiding records for the first MAX_CACHE_DEPTH bounces
    (SampleCache, src/types.h:339-345), SoA over [depth, lanes]."""
    stype: jnp.ndarray     # i32[D, B]
    tri: jnp.ndarray       # i32[D, B] global triangle id
    bucket: jnp.ndarray    # i32[D, B]
    cum_mask: jnp.ndarray  # f32[D, B, 3]

    @staticmethod
    def empty(n_lanes: int) -> 'SampleCache':
        d = MAX_CACHE_DEPTH
        return SampleCache(
            jnp.full((d, n_lanes), SAMPLE_TERMINATE, jnp.int32),
            jnp.zeros((d, n_lanes), jnp.int32),
            jnp.zeros((d, n_lanes), jnp.int32),
            jnp.ones((d, n_lanes, 3), jnp.float32))


def accumulate_buckets(state_tris: int, cache: SampleCache,
                       total_energy: jnp.ndarray):
    """The scatter half of the guiding update (kernel_update_buckets,
    kernels.h:863-882): per-(triangle, bucket) energy sums and counts via one
    segment_sum. Exposed separately so band-split or sharded renders can
    combine partial sums BEFORE the (nonlinear) EMA propagate."""
    n_tris = state_tris
    terminated_before = jnp.cumsum(
        (cache.stype == SAMPLE_TERMINATE).astype(jnp.int32), axis=0)
    alive_chain = terminated_before - (cache.stype == SAMPLE_TERMINATE)
    valid = (cache.stype == SAMPLE_BUCKET) & (alive_chain == 0)

    # fmin, not minimum: cum_mask can have exact-zero channels (saturated
    # colors / zero texels), and CUDA's fminf(100, 0/0=NaN) returns 100 —
    # jnp.minimum would instead propagate the NaN into the cache permanently
    # through the EMA clip (kernels.h:872 uses fminf).
    energy = jnp.fmin(
        ENERGY_CLAMP,
        vm.luminance(total_energy[None, :, :] / cache.cum_mask))
    energy = jnp.where(valid, energy, 0.0)
    weight = valid.astype(jnp.float32)

    seg = (cache.tri * GUIDE_BUCKETS + cache.bucket).reshape(-1)
    seg = jnp.where(valid.reshape(-1), seg, n_tris * GUIDE_BUCKETS)
    num_segments = n_tris * GUIDE_BUCKETS + 1
    # one scatter for both quantities (a trailing feature dim); on the GPU
    # XLA lowers it to atomic adds, as kernel_update_buckets does
    both = jnp.stack([energy.reshape(-1), weight.reshape(-1)], axis=-1)
    sums2 = jax.ops.segment_sum(both, seg, num_segments=num_segments)
    return (sums2[:-1, 0].reshape(n_tris, GUIDE_BUCKETS),
            sums2[:-1, 1].reshape(n_tris, GUIDE_BUCKETS))


def propagate(state: RadianceState, add_sum, add_count, enabled) -> RadianceState:
    """The EMA half (kernel_propagate_buckets, kernels.h:884-905)."""
    has = add_count >= EPS
    incoming = add_sum / jnp.maximum(add_count, 1.0)
    new_vals = jnp.clip(ALPHA * state.cache + (1.0 - ALPHA) * incoming,
                        VALUE_MIN, VALUE_MAX)
    new_cache = jnp.where(has & enabled, new_vals, state.cache)
    new_total = state.total + jnp.sum(new_cache - state.cache, axis=-1)
    return RadianceState(new_cache, new_total)


def update_radiance_state(state: RadianceState, cache: SampleCache,
                          total_energy: jnp.ndarray,
                          enabled, axis_name: str | None = None) -> RadianceState:
    """One guiding step = update buckets + propagate, fused.

    total_energy: f32[B, 3] — the pixel's accumulated color this sample.
    enabled: bool scalar (traced) — gates the whole update (the reference gates
    on converge-mode + sampleIdx < 100, src/pathtracer.h:292-296).
    axis_name: when called inside shard_map (parallel/mesh.py), the mesh axis
    to all-reduce the raw bucket sums over BEFORE the EMA — this makes the
    sharded update bit-identical to the single-chip one (per-shard means would
    not be, since the EMA+clamp is nonlinear).
    """
    n_tris = state.cache.shape[0]
    add_sum, add_count = accumulate_buckets(n_tris, cache, total_energy)
    if axis_name is not None:
        add_sum = jax.lax.psum(add_sum, axis_name)
        add_count = jax.lax.psum(add_count, axis_name)
    return propagate(state, add_sum, add_count, enabled)
