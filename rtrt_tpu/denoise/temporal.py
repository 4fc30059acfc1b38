"""Temporal reprojection filter (SVGF-style history accumulation).

Counterpart of the reference's TemporalFilter
(reference: src/temporalDenoising.cuh:610-893) and TemporalFilter2
(:896-1110): motion-vector history fetch, YCoCg neighborhood clamp,
material-mask validity, anti-flicker blend modulation, and the per-8x8-tile
noise-level estimate (:33-102) used to gate the spatial filters.

Everything is full-image (H, W, C) math built on the shifted-stack stencils
(ops/stencil.py) — one fused XLA pass instead of LDS-tiled CUDA blocks.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.color import luminance, rgb_to_ycocg, ycocg_to_rgb
from ..ops.stencil import (bicubic_catmull_rom_sample, bilinear_sample,
                           neighborhood, shifted)
from ..utils.config import DenoiseParams


def _uv_grid(h, w):
    ys = (jnp.arange(h, dtype=jnp.float32) + 0.5) / h
    xs = (jnp.arange(w, dtype=jnp.float32) + 0.5) / w
    yy, xx = jnp.meshgrid(ys, xs, indexing="ij")
    return jnp.stack([xx, yy], axis=-1)  # (H,W,2)


def temporal_filter(color, normal, depth, mat_id, motion,
                    hist_color, hist_depth, hist_mat, hist_valid,
                    p: DenoiseParams, bicubic: bool = False,
                    hist_count=None, reproj=None):
    """First temporal accumulation pass.

    color/normal: (H,W,3); depth: (H,W); mat_id: (H,W) i32; motion: (H,W,2)
    uv offsets (prev - cur); hist_*: previous-frame buffers; hist_valid: ()
    bool scalar (False on the first frame).

    hist_count: optional (H,W) accumulated sample count — when given, the
    blend is alpha = max(1/(N+1), temporal_blend) so variance decays like
    1/N until the cap (proper SVGF accumulation; a fixed EMA never converges
    below ~alpha/2 of the input variance, which kept the spatial-filter
    noise gate permanently open).  Returns (filtered, new_count) then;
    plain filtered otherwise.

    reproj: optional (hist_rgb, hist_depth, hist_mat, hist_count, ok) of
    PRE-REPROJECTED history (denoise/reproject.py) — the arbitrary-motion
    default; the in-function paths below (±1 px shift stencil / bicubic
    gather) remain as fallbacks.
    """
    h, w = color.shape[0], color.shape[1]
    uv = _uv_grid(h, w)
    prev_uv = uv + motion

    # --- history fetch ---
    # The reference bicubic-resamples history at uv+motion (:800-812), a
    # per-pixel gather.  History arrives either pre-reprojected
    # (`reproj`, arbitrary motion, denoise/reproject.py) or through a
    # ±1 px SHIFT-STENCIL fallback: bilinear resampling == a 3x3 weighted
    # sum of statically shifted history images.  Motion beyond the window
    # rejects history (temporal restart; the 1/N count resets and the
    # spatial gate reopens).  `bicubic=True` = full gather path (offline).
    if reproj is not None:
        hist, hd, hist_mat_s, n_prev_raw, rep_ok = reproj
        small_motion = rep_ok
    elif bicubic:
        hist = bicubic_catmull_rom_sample(hist_color, prev_uv)
        small_motion = jnp.ones(motion.shape[:-1], bool)
    else:
        mpx = motion * jnp.array([w, h], jnp.float32)  # pixels (prev - cur)
        small_motion = (jnp.abs(mpx[..., 0]) <= 1.0) \
            & (jnp.abs(mpx[..., 1]) <= 1.0)
        fx = jnp.clip(mpx[..., 0], -1.0, 1.0)
        fy = jnp.clip(mpx[..., 1], -1.0, 1.0)
        # separable bilinear weights over shifts {-1, 0, +1}
        wx = [jnp.maximum(0.0, 1.0 - jnp.abs(fx - s)) for s in (-1.0, 0.0, 1.0)]
        wy = [jnp.maximum(0.0, 1.0 - jnp.abs(fy - s)) for s in (-1.0, 0.0, 1.0)]
        hist = 0.0
        for iy, sy in enumerate((-1, 0, 1)):
            for ix, sx in enumerate((-1, 0, 1)):
                wgt = (wy[iy] * wx[ix])[..., None]
                hist = hist + wgt * shifted(hist_color, sy, sx)

    # --- neighborhood min/max clamp in YCoCg (:702-817) ---
    taps, _ = neighborhood(rgb_to_ycocg(color), 1)  # (9,H,W,3)
    box_min = jnp.min(taps, axis=0)
    box_max = jnp.max(taps, axis=0)
    center = 0.5 * (box_min + box_max)
    extent = 0.5 * (box_max - box_min) * p.anti_flicker + 1e-4
    hist_y = rgb_to_ycocg(hist)
    clamped = jnp.clip(hist_y, center - extent, center + extent)
    hist = ycocg_to_rgb(clamped)

    # --- history validity (:836-851) ---
    in_bounds = ((prev_uv[..., 0] >= 0.0) & (prev_uv[..., 0] <= 1.0)
                 & (prev_uv[..., 1] >= 0.0) & (prev_uv[..., 1] <= 1.0))
    if reproj is not None:
        in_bounds = in_bounds & small_motion
    elif bicubic:
        hx = jnp.clip((prev_uv[..., 0] * w).astype(jnp.int32), 0, w - 1)
        hy = jnp.clip((prev_uv[..., 1] * h).astype(jnp.int32), 0, h - 1)
        hist_mat_s = hist_mat[hy, hx]
        hd = hist_depth[hy, hx]
    else:
        # nearest-shift history mat/depth via the same zero-gather stencils
        rx = jnp.round(jnp.clip(motion[..., 0] * w, -1, 1)).astype(jnp.int32)
        ry = jnp.round(jnp.clip(motion[..., 1] * h, -1, 1)).astype(jnp.int32)
        hist_mat_s = jnp.zeros_like(mat_id)
        hd = jnp.zeros_like(hist_depth)
        for sy in (-1, 0, 1):
            for sx in (-1, 0, 1):
                sel = (rx == sx) & (ry == sy)
                hist_mat_s = jnp.where(sel, shifted(hist_mat, sy, sx),
                                       hist_mat_s)
                hd = jnp.where(sel, shifted(hist_depth, sy, sx), hd)
        in_bounds = in_bounds & small_motion
    mat_ok = hist_mat_s == mat_id
    both_fin = jnp.isfinite(depth) & jnp.isfinite(hd)
    depth_ok = jnp.where(
        both_fin,
        jnp.abs(hd - depth) <= p.sigma_depth * jnp.maximum(depth, 1.0) * 4.0 + 1e-3,
        ~jnp.isfinite(depth) & ~jnp.isfinite(hd))  # both sky is fine
    ok = in_bounds & mat_ok & depth_ok & hist_valid

    # --- blend ---
    if hist_count is not None:
        # reprojected sample count (nearest is fine for count)
        if reproj is not None:
            n_prev = jnp.where(ok, n_prev_raw, 0.0)
        elif bicubic:
            n_prev = jnp.where(ok, hist_count[hy, hx], 0.0)
        else:
            nc = jnp.zeros_like(hist_count)
            for sy in (-1, 0, 1):
                for sx in (-1, 0, 1):
                    sel = (rx == sx) & (ry == sy)
                    nc = jnp.where(sel, shifted(hist_count, sy, sx), nc)
            n_prev = jnp.where(ok, nc, 0.0)
        alpha = jnp.maximum(1.0 / (n_prev + 1.0), p.temporal_blend)
        alpha = jnp.where(ok, alpha, 1.0)
        out = color * alpha[..., None] + hist * (1.0 - alpha[..., None])
        new_count = jnp.minimum(n_prev + 1.0, 1.0 / jnp.maximum(
            p.temporal_blend, 1e-3))
        return out, new_count
    # luma-weighted EMA (:853-887): darker pixels get more history
    blend = jnp.clip(p.temporal_blend
                     * (1.0 + luminance(color) * 0.5), 0.0, 1.0)
    blend = jnp.where(ok, blend, 1.0)[..., None]
    return color * blend + hist * (1.0 - blend)


def tile_noise_level(color, depth, tile: int = 8):
    """Per-tile luminance relative variance, scaled by the non-sky ratio
    (reference: CalculateTileNoiseLevel, temporalDenoising.cuh:33-91).
    Returns (H/tile, W/tile)."""
    from ..ops.resize import box_pool
    lum = luminance(color)
    not_sky = jnp.isfinite(depth).astype(jnp.float32)
    mean = box_pool(lum, tile)
    meansq = box_pool(lum * lum, tile)
    var = jnp.maximum(meansq - mean * mean, 0.0)
    ratio = box_pool(not_sky, tile)
    return var / jnp.maximum(mean * mean, 1e-4) * ratio


def tile_noise_downsample(noise):
    """8x8 -> 16x16 tile noise (2x2 average)
    (reference: TileNoiseLevel8x8to16x16, :93-102)."""
    from ..ops.resize import box_pool
    return box_pool(noise, 2)


def noise_level_visualize(img, noise, threshold, tile: int = 8):
    """Debug overlay: tint tiles whose noise exceeds the threshold orange
    (reference: TileNoiseLevelVisualize, :104-140)."""
    h, w = img.shape[0], img.shape[1]
    up = jnp.repeat(jnp.repeat(noise, tile, axis=0), tile, axis=1)[:h, :w]
    pad_h, pad_w = h - up.shape[0], w - up.shape[1]
    if pad_h or pad_w:
        up = jnp.pad(up, ((0, pad_h), (0, pad_w)), mode="edge")
    mask = (up > threshold)[..., None]
    tint = jnp.array([1.0, 0.5, 0.1], jnp.float32)
    return jnp.where(mask, img * 0.5 + tint * 0.5, img)
