"""Resolution pyramid ops: box downsample and Catmull-Rom upscale.

Counterpart of the reference's DownScale4 pyramid (reference:
src/postprocessing.cuh:142, launches src/postprocessing.cu:21-35), the
BicubicScale render->screen upscale (:785+), and mip generation
(src/mipgen.cu:121-182).  Pure reshape-reduce / gather math that XLA maps
straight onto vector units.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .stencil import bicubic_catmull_rom_sample


def box_pool(img, k: int):
    """k x k mean pool via lax.reduce_window (layout-friendly: the
    reshape-to-(H/k,k,W/k,k) formulation forces a hostile tiling that
    XLA propagates across the whole image pipeline — measured ~0.9s of
    relayout copies per 1080p frame)."""
    h, w = (img.shape[0] // k) * k, (img.shape[1] // k) * k
    x = img[:h, :w]
    dims = (k, k) + (1,) * (img.ndim - 2)
    out = jax.lax.reduce_window(x, 0.0, jax.lax.add, dims, dims, "VALID")
    return out / (k * k)


def downsample2(img):
    """2x2 box average; (H,W,C)->(H/2,W/2,C) (truncates odd edges)."""
    return box_pool(img, 2)


def downsample4(img):
    """4x4 box average — the reference's DownScale4 unit."""
    return box_pool(img, 4)


def upsample_linear(img, out_h: int, out_w: int):
    """Bilinear upsample to (out_h, out_w) as two dense weight-matrix
    contractions (jax.image.resize 'linear', full float32 precision) —
    matmul work, zero gathers, instead of a full-res 5x5 stencil per
    buffer."""
    return jax.image.resize(img, (out_h, out_w) + img.shape[2:],
                            method="linear")


def upscale_catmull_rom(img, out_h: int, out_w: int):
    """Catmull-Rom bicubic resample to (out_h, out_w) — the reference's
    render-res -> screen-res BicubicScale."""
    ys = (jnp.arange(out_h, dtype=jnp.float32) + 0.5) / out_h
    xs = (jnp.arange(out_w, dtype=jnp.float32) + 0.5) / out_w
    yy, xx = jnp.meshgrid(ys, xs, indexing="ij")
    uv = jnp.stack([xx, yy], axis=-1)
    return bicubic_catmull_rom_sample(img, uv)
