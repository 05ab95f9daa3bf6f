"""Film: accumulators, luminance Gaussian filter, display transform, audits.

Replaces the reference's GL surfaces + GLSL post chain (src/main.cpp:30-171):
the RGBA32F luminance/albedo accumulation textures become [H*W, 4] arrays, the
two compute-shader Gaussian passes (gauss_horz 7-tap, gauss_vert 8-tap with
sample-count-dependent spread) become masked shift-adds (XLA fuses them into a
single pass over the image), and the final gamma-2.0 + vignette fragment
shader is `display()`.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..constants import PI


def clear_accumulators(n_pixels: int):
    """kernel_clear_screen for both surfaces (src/kernels.h:826-832)."""
    return (jnp.zeros((n_pixels, 4), jnp.float32),
            jnp.zeros((n_pixels, 4), jnp.float32))


def accumulate(lum, add_rgb, n_samples: float = 1.0):
    """kernel_add_to_screen (src/kernels.h:812-824): rgb += sample color,
    w += n. Negative old values are clamped like the surf2Dread guard.
    `n_samples` > 1 when the engine batched several spp into one wavefront."""
    old = jnp.maximum(lum[:, :3], 0.0)
    return jnp.concatenate([old + add_rgb, lum[:, 3:4] + n_samples], axis=1)


def accumulate_albedo(alb, add_rgb, inc):
    """updateAlbedo (src/kernels.h:56-62); w counts writes, not samples."""
    old = jnp.maximum(alb[:, :3], 0.0)
    return jnp.concatenate([old + add_rgb, alb[:, 3:4] + inc[:, None]], axis=1)


def _gauss_weights(offsets, spread):
    return jnp.exp(-(offsets ** 2) * 0.5 * spread) / jnp.sqrt(2.0 * PI)


def _blur_axis(img, axis, offsets, spread):
    """Masked shifted-sum Gaussian along one image axis with edge
    renormalization (the `continue` + sum normalization of main.cpp:126-139)."""
    n = img.shape[axis]
    idx = jnp.arange(n)
    acc = jnp.zeros_like(img)
    wsum = jnp.zeros(img.shape[:-1], img.dtype)
    for off in offsets:
        w = _gauss_weights(jnp.float32(off), spread)
        shifted = jnp.roll(img, -off, axis=axis)
        valid = (idx + off >= 0) & (idx + off < n)
        vshape = [1, 1]
        vshape[axis] = n
        validb = valid.reshape(vshape)
        acc = acc + jnp.where(validb[..., None], shifted * w, 0.0)
        wsum = wsum + jnp.where(validb, w, 0.0)
    return acc / wsum[..., None]


def blur_luminance(lum, alb, n_samples, width: int, height: int):
    """The separable luminance blur (gauss_horz/gauss_vert,
    src/main.cpp:111-171): horizontal over luminance/albedo * nrSamples with
    taps i=-3..3, vertical over the result with taps i=-4..3, spread
    max(0.7, n/200). Returns the blurred luminance [H*W, 3] whose implicit
    w is n_samples. XLA fuses the shifted adds into one pass."""
    spread = jnp.maximum(0.7, n_samples / 200.0)
    lum_img = lum[:, :3].reshape(height, width, 3)
    alb_img = alb[:, :3].reshape(height, width, 3)
    c = (lum_img / jnp.maximum(alb_img, 0.001)) * n_samples
    h = _blur_axis(c, 1, range(-3, 4), spread)
    v = _blur_axis(h, 0, range(-4, 4), spread)
    return v.reshape(-1, 3)


def display(lum, alb, n_samples, width: int, height: int, blur: bool = False):
    """Final display transform (quad_fs / quad_fs_blurred,
    src/main.cpp:46-108): divide by sample count, optionally multiply the
    blurred luminance by per-pixel albedo, gamma 2.0, vignette.
    Returns f32[H, W, 3] in [0, ~1], bottom-row-first."""
    if blur:
        blurred = blur_luminance(lum, alb, n_samples, width, height)
        lum_c = blurred / jnp.maximum(n_samples, 1.0)
        alb_c = alb[:, :3] / jnp.maximum(alb[:, 3:4], 1e-9)
        color = lum_c * alb_c
    else:
        color = lum[:, :3] / jnp.maximum(lum[:, 3:4], 1e-9)
    color = jnp.sqrt(jnp.maximum(color, 0.0))  # gamma 2.0
    img = color.reshape(height, width, 3)
    ys = (jnp.arange(height, dtype=jnp.float32) + 0.5) / height - 0.5
    xs = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width - 0.5
    vign = 1.0 - (xs[None, :] ** 2 + ys[:, None] ** 2)
    return img * vign[..., None]


def energy_audit(lum):
    """The DEBUG_ENERGY check (src/main.cpp:342-366): per-sample mean energy
    and NaN/negativity flags. Returns (energy, has_nan, has_negative)."""
    rgb = lum[:, :3]
    w = jnp.maximum(lum[:, 3:4], 1.0)
    sample = jnp.mean(rgb, axis=1)
    has_nan = jnp.any(jnp.isnan(rgb))
    has_neg = jnp.any(rgb < 0.0)
    total = jnp.sum(jnp.where(jnp.isnan(sample), 0.0, sample)) / jnp.mean(w)
    return total, has_nan, has_neg


def to_uint8(img) -> np.ndarray:
    return np.asarray(jnp.clip(img * 255.0, 0, 255).astype(jnp.uint8))
