"""The luminance blur (models/film.blur_luminance, XLA) against a direct
numpy loop over the reference's two compute-shader passes
(gauss_horz / gauss_vert, src/main.cpp:111-171)."""
import numpy as np
import jax.numpy as jnp

from cuda_pathtracer_tpu.models import film

W, H = 64, 48


def _accumulators(seed=0, n=12.0):
    rng = np.random.RandomState(seed)
    lum = np.concatenate([rng.rand(H * W, 3).astype(np.float32) * n,
                          np.full((H * W, 1), n, np.float32)], axis=1)
    alb = np.concatenate([rng.rand(H * W, 3).astype(np.float32) * n + 0.1,
                          np.full((H * W, 1), n, np.float32)], axis=1)
    return lum, alb


def _reference_blur(lum, alb, n):
    """Per-pixel loops: horizontal taps -3..3 over luminance / albedo * n,
    then vertical taps -4..3 over that; out-of-image taps are skipped and
    the weights renormalized."""
    spread = max(0.7, n / 200.0)
    c = (lum[:, :3] / np.maximum(alb[:, :3], 0.001) * n).reshape(H, W, 3)
    c = c.astype(np.float64)

    def weight(off):
        return np.exp(-(off ** 2) * 0.5 * spread) / np.sqrt(2.0 * np.pi)

    h = np.zeros_like(c)
    for y in range(H):
        for x in range(W):
            acc, ws = np.zeros(3), 0.0
            for i in range(-3, 4):
                if 0 <= x + i < W:
                    acc += c[y, x + i] * weight(i)
                    ws += weight(i)
            h[y, x] = acc / ws
    v = np.zeros_like(c)
    for y in range(H):
        for x in range(W):
            acc, ws = np.zeros(3), 0.0
            for i in range(-4, 4):
                if 0 <= y + i < H:
                    acc += h[y + i, x] * weight(i)
                    ws += weight(i)
            v[y, x] = acc / ws
    return v.reshape(-1, 3)


def test_pallas_blur_matches_xla():
    lum, alb = _accumulators()
    for n in (1.0, 12.0, 500.0):   # spans the spread regimes
        got = np.asarray(film.blur_luminance(jnp.asarray(lum),
                                             jnp.asarray(alb), n, W, H))
        want = _reference_blur(lum, alb, n)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_blur_preserves_flat_image():
    """A flat image stays flat: the edge renormalization keeps border
    pixels at the interior value."""
    lum = np.concatenate([np.full((H * W, 3), 6.0, np.float32),
                          np.full((H * W, 1), 12.0, np.float32)], axis=1)
    alb = np.concatenate([np.full((H * W, 3), 2.0, np.float32),
                          np.full((H * W, 1), 12.0, np.float32)], axis=1)
    got = np.asarray(film.blur_luminance(jnp.asarray(lum), jnp.asarray(alb),
                                         12.0, W, H))
    np.testing.assert_allclose(got, 36.0, rtol=1e-5)
