"""Table-row lookup helpers.

For the renderer's small tables (materials: ~a dozen rows; lights: a
handful) an unrolled select chain fetches rows with elementwise work instead
of a gather.

Why selects and not a one-hot matmul: the packed tables carry int32 fields
BITCAST into f32 lanes (material ids, texture ids). Small ints bitcast to f32
are denormals, which a device that flushes denormals to zero in arithmetic
(multiply-by-one-hot, add-zero) would silently zero. jnp.where is a pure
select and bit-preserving (tests/test_gpu.py checks the ids on the card).
"""
from __future__ import annotations

import jax.numpy as jnp

# crossover: the select chain costs K passes over [B, F]; beyond this a
# gather is used
SELECT_MAX_ROWS = 32


def table_lookup(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """rows = table[idx] with the fast path for small tables.

    table: f32[K, F]; idx: i32[B] (out-of-range behaves like clamp, matching
    XLA gather). Returns f32[B, F], bit-exact against the gather path.
    """
    k = table.shape[0]
    if k == 0 or k > SELECT_MAX_ROWS:
        return table[idx]
    out = jnp.broadcast_to(table[0][None, :], (idx.shape[0], table.shape[1]))
    for i in range(1, k):
        # >= i (not == i) gives gather's high-side clamp semantics for free
        out = jnp.where((idx >= i)[:, None], table[i][None, :], out)
    return out
