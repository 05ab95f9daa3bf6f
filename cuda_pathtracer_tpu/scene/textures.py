"""Image loading and the flat texture atlas.

The reference binds each image as a bilinear-filtered CUDA texture object
(src/use_cuda.h:108-263). Here all textures live in one flat texel array in
device memory and sampling is row gathers + a lerp — the
bilinear/wrap semantics are reproduced in :func:`sample_bilinear`.

Decoding uses PIL (jpg/png) plus a small Radiance .hdr reader; like the
reference we load LDR data linearly (stbi_ldr_to_hdr_gamma(1.0f),
src/use_cuda.h:169,207): an 8-bit value maps to value/255 with no gamma.
Images are stored bottom-row-first, matching the reference's vertical flip
(src/use_cuda.h:125-133).
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import jax.numpy as jnp


def _read_hdr(path: str) -> np.ndarray:
    """Minimal Radiance RGBE (.hdr) decoder -> float32 [H, W, 3]."""
    with open(path, 'rb') as f:
        data = f.read()
    # header ends at blank line, then a resolution line
    pos = data.find(b'\n\n')
    if pos < 0:
        raise ValueError(f'bad hdr header in {path}')
    header_end = pos + 2
    nl = data.find(b'\n', header_end)
    res = data[header_end:nl].split()
    if len(res) != 4 or res[0] != b'-Y' or res[2] != b'+X':
        raise ValueError(f'unsupported hdr layout in {path}: {res}')
    height, width = int(res[1]), int(res[3])
    buf = np.frombuffer(data, np.uint8, offset=nl + 1)
    rgbe = np.zeros((height, width, 4), np.uint8)
    p = 0
    for y in range(height):
        if p + 4 <= len(buf) and buf[p] == 2 and buf[p + 1] == 2 and \
                (int(buf[p + 2]) << 8 | int(buf[p + 3])) == width:
            # adaptive RLE scanline
            p += 4
            for c in range(4):
                x = 0
                while x < width:
                    count = int(buf[p]); p += 1
                    if count > 128:  # run
                        rgbe[y, x:x + count - 128, c] = buf[p]
                        p += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x:x + count, c] = buf[p:p + count]
                        p += count
                        x += count
        else:  # flat scanline
            row = buf[p:p + 4 * width].reshape(width, 4)
            rgbe[y] = row
            p += 4 * width
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def load_image(path: str) -> np.ndarray:
    """Decode an image to linear float32 [H, W, C], bottom row first."""
    if path.lower().endswith('.hdr'):
        img = _read_hdr(path)
    else:
        from PIL import Image
        with Image.open(path) as im:
            if im.mode not in ('RGB', 'RGBA', 'L'):
                im = im.convert('RGB')
            img = np.asarray(im, np.float32) / 255.0
            if img.ndim == 2:
                img = img[..., None]
    return np.ascontiguousarray(img[::-1])  # flip to bottom-row-first


class TextureStack(NamedTuple):
    """Device-side atlas: all texels flattened, per-texture offset/size.

    `pairs` holds, for every texel, itself ++ its wrap-adjacent right
    neighbor (within its own texture), so a bilinear fetch needs TWO row
    gathers (bottom pair + top pair) instead of four corner rows. (A 12-wide
    QUAD table was laid out column-major by XLA for this consumer shape, so
    each row fetch became 12 strided reads; the [2, B]-indexed pair form
    keeps rows contiguous.)"""
    texels: jnp.ndarray   # f32[P, 3]
    pairs: jnp.ndarray    # f32[P, 6]: texel(x,y) ++ texel((x+1)%W, y)
    offset: jnp.ndarray   # i32[K]
    width: jnp.ndarray    # i32[K]
    height: jnp.ndarray   # i32[K]


class TextureAtlas:
    """Host-side builder with path dedup (the textureItems map of
    src/scene.h:174,214-244)."""

    def __init__(self):
        self._images: list[np.ndarray] = []
        self._by_path: dict[str, int] = {}

    def add_path(self, path: str, search_dirs=()) -> int:
        full = path
        if not os.path.exists(full):
            for d in search_dirs:
                cand = os.path.join(d, os.path.basename(path))
                if os.path.exists(cand):
                    full = cand
                    break
        # dedup on the resolved path (the reference keys its textureItems map
        # on the full texname, scene.h:214-244) — basename alone would alias
        # distinct textures that share a filename across directories
        key = os.path.realpath(full)
        if key in self._by_path:
            return self._by_path[key]
        img = load_image(full)
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        idx = len(self._images)
        self._images.append(img[..., :3])
        self._by_path[key] = idx
        return idx

    def add_array(self, img: np.ndarray) -> int:
        idx = len(self._images)
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        self._images.append(img[..., :3])
        return idx

    def __len__(self):
        return len(self._images)

    def build(self) -> TextureStack:
        if not self._images:
            # one white 1x1 texel so the arrays are never empty
            self._images.append(np.ones((1, 1, 3), np.float32))
        offsets, ws, hs, flats, pairflats = [], [], [], [], []
        off = 0
        for img in self._images:
            h, w, _ = img.shape
            offsets.append(off)
            ws.append(w)
            hs.append(h)
            flats.append(img.reshape(-1, 3))
            pairflats.append(np.concatenate(
                [img, np.roll(img, -1, axis=1)], axis=-1).reshape(-1, 6))
            off += w * h
        return TextureStack(
            texels=jnp.asarray(np.concatenate(flats, axis=0)),
            pairs=jnp.asarray(np.concatenate(pairflats, axis=0)),
            offset=jnp.asarray(np.array(offsets, np.int32)),
            width=jnp.asarray(np.array(ws, np.int32)),
            height=jnp.asarray(np.array(hs, np.int32)))


def sample_bilinear(stack: TextureStack, tex_id, u, v, live=None):
    """Bilinear, wrap-addressed texture fetch — the semantics of the CUDA
    texture objects created in src/use_cuda.h:145-151 (normalizedCoords, wrap,
    linear filter). `tex_id`, `u`, `v` are arrays of the same batch shape.
    Returns f32[..., 3]. `live` masks lanes whose result the caller consumes:
    dead lanes gather row 0 (cached) instead of a uv-dependent random row.

    CUDA linear filtering samples at (u*W - 0.5) between texel centers; we
    reproduce that so goldens line up.
    """
    w = stack.width[tex_id]
    h = stack.height[tex_id]
    off = stack.offset[tex_id]
    fu = u * w.astype(jnp.float32) - 0.5
    fv = v * h.astype(jnp.float32) - 0.5
    x0 = jnp.floor(fu)
    y0 = jnp.floor(fv)
    tx = (fu - x0)[..., None]
    ty = (fv - y0)[..., None]

    # two batched PAIR gathers (bottom row pair, top row pair) — the pair
    # table pre-packs each texel with its wrap-adjacent right neighbor, so
    # this touches half the rows of a four-corner gather, bit-identically
    xi = jnp.mod(x0.astype(jnp.int32), w)
    y0i = jnp.mod(y0.astype(jnp.int32), h)
    y1i = jnp.mod(y0.astype(jnp.int32) + 1, h)
    idx2 = jnp.stack([off + y0i * w + xi, off + y1i * w + xi])
    if live is not None:
        idx2 = jnp.where(live, idx2, 0)
    rows = stack.pairs[idx2]
    c00, c10 = rows[0][..., 0:3], rows[0][..., 3:6]
    c01, c11 = rows[1][..., 0:3], rows[1][..., 3:6]
    return ((c00 * (1 - tx) + c10 * tx) * (1 - ty)
            + (c01 * (1 - tx) + c11 * tx) * ty)


def sample_nearest(stack: TextureStack, tex_id, u, v):
    """Point-sampled wrap fetch (the blue-noise texture uses
    cudaFilterModePoint, src/use_cuda.h:187)."""
    w = stack.width[tex_id]
    h = stack.height[tex_id]
    off = stack.offset[tex_id]
    xi = jnp.mod((u * w.astype(jnp.float32)).astype(jnp.int32), w)
    yi = jnp.mod((v * h.astype(jnp.float32)).astype(jnp.int32), h)
    return stack.texels[off + yi * w + xi]
