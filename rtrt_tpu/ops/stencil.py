"""2D stencil machinery: shifted-stack neighborhoods and bilinear resampling.

Replacement for the reference's shared-memory stencil tiling
(reference: src/temporalDenoising.cuh:335-395 loads a 22x22 halo tile into
LDS per 8x8 block).  Here an R-radius stencil is a stack of
statically-shifted full images — XLA fuses the shifts with the per-tap
weight math into one pass over device memory.  A fused GPU stencil kernel
for the widest filters is a later option (ROADMAP).

All images are (H, W, C) or (H, W).
"""

from __future__ import annotations

import jax.numpy as jnp


def shifted(img, dy: int, dx: int):
    """Image translated by (dy, dx) with edge-clamp boundary (the analog of
    the reference's clamped Load2D boundary functors, src/sampler.cuh:33-283).
    Positive dy shifts content up (i.e. out[y] = img[y+dy])."""
    h, w = img.shape[0], img.shape[1]
    py0, py1 = max(dy, 0), max(-dy, 0)
    px0, px1 = max(dx, 0), max(-dx, 0)
    pad_width = [(py1, py0), (px1, px0)] + [(0, 0)] * (img.ndim - 2)
    padded = jnp.pad(img, pad_width, mode="edge")
    return padded[py0:py0 + h, px0:px0 + w]


def neighborhood(img, radius: int, stride: int = 1):
    """All (2r+1)^2 shifted copies: returns (K, H, W, ...) stack plus the
    matching (K, 2) integer offsets."""
    taps = []
    offsets = []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            taps.append(shifted(img, dy * stride, dx * stride))
            offsets.append((dy, dx))
    return jnp.stack(taps, axis=0), jnp.asarray(offsets, jnp.int32)


def bilinear_sample(img, uv):
    """Bilinear sample at continuous uv in [0,1]^2 (clamped); img (H,W,C),
    uv (...,2) -> (...,C)."""
    h, w = img.shape[0], img.shape[1]
    x = jnp.clip(uv[..., 0] * w - 0.5, 0.0, w - 1.0)
    y = jnp.clip(uv[..., 1] * h - 0.5, 0.0, h - 1.0)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    x1i = jnp.minimum(x0i + 1, w - 1)
    y1i = jnp.minimum(y0i + 1, h - 1)
    c00 = img[y0i, x0i]
    c01 = img[y0i, x1i]
    c10 = img[y1i, x0i]
    c11 = img[y1i, x1i]
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) \
        + (c10 * (1 - fx) + c11 * fx) * fy


def _catmull_rom_w(f):
    """Catmull-Rom weights for fractional position f (...,): returns 4 taps."""
    f2 = f * f
    f3 = f2 * f
    w0 = -0.5 * f3 + f2 - 0.5 * f
    w1 = 1.5 * f3 - 2.5 * f2 + 1.0
    w2 = -1.5 * f3 + 2.0 * f2 + 0.5 * f
    w3 = 0.5 * f3 - 0.5 * f2
    return w0, w1, w2, w3


def bicubic_catmull_rom_sample(img, uv):
    """16-tap Catmull-Rom bicubic (the reference's history / upscale filter,
    src/sampler.cuh:392-594).  img (H,W,C); uv (...,2) clamped."""
    h, w = img.shape[0], img.shape[1]
    x = jnp.clip(uv[..., 0] * w - 0.5, 0.0, w - 1.0)
    y = jnp.clip(uv[..., 1] * h - 0.5, 0.0, h - 1.0)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    wx = _catmull_rom_w(fx)
    wy = _catmull_rom_w(fy)
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    acc = 0.0
    for j in range(4):
        yy = jnp.clip(y0i + (j - 1), 0, h - 1)
        row = 0.0
        for i in range(4):
            xx = jnp.clip(x0i + (i - 1), 0, w - 1)
            row = row + img[yy, xx] * wx[i][..., None]
        acc = acc + row * wy[j][..., None]
    return acc


def gaussian_weights(radius: int, sigma: float | None = None):
    """Normalized (2r+1)^2 gaussian tap weights, flattened (K,)
    (reference: precomputed 3x3/5x5/7x7 tables, src/gaussian.cuh:12-45)."""
    import numpy as np
    if sigma is None:
        sigma = radius * 0.5 + 0.25
    ax = np.arange(-radius, radius + 1)
    k = np.exp(-(ax ** 2) / (2.0 * sigma ** 2))
    k2 = np.outer(k, k)
    return jnp.asarray((k2 / k2.sum()).reshape(-1), jnp.float32)
