"""Vector math over jnp arrays with a trailing xyz axis.

The reference uses float3/float4 helper operators (src/cutil_math.h, incl. the
project-added fmincompf/fmaxcompf at cutil_math.h:283-293). Here every "float3"
is an array of shape [..., 3] and all helpers broadcast over leading axes, so a
whole wavefront of rays is one VPU-shaped array op.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# f32 products in full f32: a GPU may otherwise run them in TF32
_HIGHEST = jax.lax.Precision.HIGHEST


def dot(a, b):
    """Batched 3-vector dot product -> [...]."""
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def length(a):
    return jnp.sqrt(jnp.maximum(dot(a, a), 0.0))


def normalize(a, eps: float = 0.0):
    l = length(a)
    if eps:
        l = jnp.maximum(l, eps)
    return a / l[..., None]


def reflect(d, n):
    """Mirror direction `d` about normal `n` (matches CUDA reflect())."""
    return d - 2.0 * dot(d, n)[..., None] * n


def max_comp(a):
    """Component max of a float3 (reference fmaxcompf, cutil_math.h:288-293)."""
    return jnp.max(a, axis=-1)


def min_comp(a):
    return jnp.min(a, axis=-1)


def luminance(c):
    """Rec.601 luma (reference: src/kernels.h:51-54)."""
    return 0.299 * c[..., 0] + 0.587 * c[..., 1] + 0.114 * c[..., 2]


def lerp(a, b, t):
    return a + (b - a) * t


def vec3(x, y, z):
    return jnp.stack(jnp.broadcast_arrays(
        jnp.asarray(x, jnp.float32),
        jnp.asarray(y, jnp.float32),
        jnp.asarray(z, jnp.float32)), axis=-1)


def transform_point(m, p):
    """Apply affine [..., 3, 4] transform(s) to point(s) [..., 3].

    Equivalent of the reference mat4x3::mul(target, 1.0f) (src/types.h:401-406).
    """
    return jnp.einsum('...ij,...j->...i', m[..., :, :3], p,
                      precision=_HIGHEST) + m[..., :, 3]


def transform_dir(m, d):
    """Apply the linear part of an affine transform to direction(s).

    Equivalent of mat4x3::mul(target, 0.0f) (src/types.h:401-406).
    """
    return jnp.einsum('...ij,...j->...i', m[..., :, :3], d,
                      precision=_HIGHEST)


def orthonormal_basis(w):
    """Build (u, v) perpendicular to w using the reference's branch
    (src/kernels.h:398-400): pick +Y when |w.x| > 0.1 else +X as the helper."""
    helper = jnp.where((jnp.abs(w[..., 0]) > 0.1)[..., None],
                       jnp.array([0.0, 1.0, 0.0], jnp.float32),
                       jnp.array([1.0, 0.0, 0.0], jnp.float32))
    u = normalize(cross(helper, w))
    v = normalize(cross(w, u))
    return u, v
