"""Arbitrary-motion history reprojection.

The reference reprojects denoiser history with a per-pixel bicubic fetch at
uv+motion (reference: src/temporalDenoising.cuh:800-812) — a gather per
tap.  `reproject_gather` does the same: every history plane is resampled
at the motion-displaced position, color with the history filter below,
depth / material / sample count with the nearest texel.  Lanes whose
position leaves the image report ok=False and the temporal filter
restarts them (disocclusion semantics).
"""

from __future__ import annotations

import os as _os
from typing import NamedTuple

import jax.numpy as jnp

# History resampling filter.  The reference's temporal filter fetches
# history with bicubic Catmull-Rom by DEFAULT (reference:
# src/temporalDenoising.cuh:800-812, SampleBicubicCatmullRom) — sharper
# accumulation under sub-pixel jitter than bilinear, which low-passes the
# history a little every frame.  CR's overshoot is bounded downstream by
# the temporal filter's YCoCg neighborhood clamp (same as the reference).
# RTRT_HISTORY_FILTER=bilinear selects bilinear for A/B.
HISTORY_FILTER = _os.environ.get("RTRT_HISTORY_FILTER", "catmull_rom")


def _w_bilinear(d):
    return jnp.maximum(0.0, 1.0 - jnp.abs(d))


def _w_catmull_rom(d):
    """1-D Catmull-Rom kernel (a = -1/2), support |d| < 2."""
    t = jnp.abs(d)
    inner = (1.5 * t - 2.5) * t * t + 1.0
    outer = ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0
    return jnp.where(t <= 1.0, inner, jnp.where(t < 2.0, outer, 0.0))


def _w_filter(d):
    return (_w_catmull_rom if HISTORY_FILTER == "catmull_rom"
            else _w_bilinear)(d)


class Reprojection(NamedTuple):
    """History resampled at uv+motion for every pixel (garbage where ~ok)."""

    color: jnp.ndarray    # (H,W,3) pass-1 history
    color2: jnp.ndarray   # (H,W,3) pass-2 history
    depth: jnp.ndarray    # (H,W)   nearest
    mat_id: jnp.ndarray   # (H,W)   nearest i32
    count: jnp.ndarray    # (H,W)   nearest accumulation count
    ok: jnp.ndarray       # (H,W)   bool: footprint inside the image


def reproject_gather(color, color2, depth, mat_id, count, motion
                     ) -> Reprojection:
    """Resample every history plane at uv+motion with per-pixel gathers
    (the reference's bicubic history fetch); `ok` is False where the
    footprint leaves the image."""
    h, w = depth.shape
    yy, xx = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    yh = yy + motion[..., 1] * h
    xh = xx + motion[..., 0] * w

    y0f = jnp.floor(yh)
    x0f = jnp.floor(xh)
    fy = yh - y0f
    fx = xh - x0f
    y0i = y0f.astype(jnp.int32)
    x0i = x0f.astype(jnp.int32)

    # footprint taps: bilinear uses {0,1}; Catmull-Rom {-1,0,1,2} (the
    # filter default — see HISTORY_FILTER above)
    taps = (0, 1) if HISTORY_FILTER == "bilinear" else (-1, 0, 1, 2)

    def resample(img):
        acc = 0.0
        for ky in taps:
            yi = jnp.clip(y0i + ky, 0, h - 1)
            wy = _w_filter(fy - ky)
            wyc = wy[..., None] if img.ndim == 3 else wy
            for kx in taps:
                xi = jnp.clip(x0i + kx, 0, w - 1)
                wx = _w_filter(fx - kx)
                wxc = wx[..., None] if img.ndim == 3 else wx
                acc = acc + wyc * wxc * img[yi, xi]
        return acc

    nyi = jnp.clip(jnp.round(yh).astype(jnp.int32), 0, h - 1)
    nxi = jnp.clip(jnp.round(xh).astype(jnp.int32), 0, w - 1)
    ok = (yh >= 0.0) & (yh <= h - 1.0) & (xh >= 0.0) & (xh <= w - 1.0)
    return Reprojection(
        color=resample(color), color2=resample(color2),
        depth=depth[nyi, nxi], mat_id=mat_id[nyi, nxi],
        count=count[nyi, nxi], ok=ok)
