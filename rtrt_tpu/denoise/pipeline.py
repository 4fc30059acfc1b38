"""Full SVGF-style denoising chain.

Counterpart of the reference's host sequence
(reference: src/denoising.cu:5-189, pipeline diagram at :7-46):

    TemporalFilter -> tile noise -> SpatialFilter7x7 -> copy history
    -> tile noise 16 -> 3x SpatialFilterGlobal5x5 (strides 3/6/12)
    -> ApplyAlbedo -> TemporalFilter2 -> copy history2

Differences by design: the whole chain is ONE jitted function (no kernel
launches / device syncs between passes), history "copies" are just returned
arrays, and noise gating lerps instead of skipping tiles (static shapes).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..utils.config import DenoiseParams, FeatureFlags
from .spatial import spatial_filter_7x7, spatial_filter_wide
from .temporal import temporal_filter, tile_noise_downsample, tile_noise_level


class DenoiseHistory(NamedTuple):
    """Persistent history state (the reference's history buffer set:
    HistoryColorBuffer / HistoryColorDepth / material mask copies,
    temporalDenoising.cuh:142-170) + an accumulated sample count for
    1/N temporal blending."""

    color: jnp.ndarray    # (H,W,3) post-spatial accumulation (pass 1 target)
    color2: jnp.ndarray   # (H,W,3) post-everything accumulation (pass 2)
    depth: jnp.ndarray    # (H,W)
    mat_id: jnp.ndarray   # (H,W) i32
    valid: jnp.ndarray    # () bool — False on the first frame
    count: jnp.ndarray = None  # (H,W) accumulated samples (disocclusion-reset)


def init_history(h: int, w: int, half: bool = True) -> DenoiseHistory:
    """half=True stores color/color2/depth/count as bf16 (must match
    FeatureFlags.half_history so the steady-state dtypes equal the initial
    ones — otherwise frame 2 would recompile)."""
    dt = jnp.bfloat16 if half else jnp.float32
    return DenoiseHistory(
        color=jnp.zeros((h, w, 3), dt),
        color2=jnp.zeros((h, w, 3), dt),
        depth=jnp.full((h, w), jnp.inf, dt),
        mat_id=jnp.full((h, w), -1, jnp.int32),
        valid=jnp.asarray(False),
        count=jnp.zeros((h, w), dt),
    )


def denoise(color, albedo, normal, depth, mat_id, motion,
            history: DenoiseHistory, p: DenoiseParams, flags: FeatureFlags,
            frame_parity: int = 0):
    """Run the chain on demodulated radiance; history is reprojected at
    arbitrary motion (denoise/reproject.py).
    Returns (final_color_with_albedo, new_history).
    """
    c = color
    # bf16 history storage (reference: half-precision history surfaces,
    # src/fp16Utils.cuh, init.cu:473-500): halves persistent-buffer HBM
    # traffic; all filter math stays f32 (upcast on read, cast on store)
    if history.color.dtype != jnp.float32:
        history = history._replace(
            color=history.color.astype(jnp.float32),
            color2=history.color2.astype(jnp.float32),
            depth=history.depth.astype(jnp.float32),
            count=history.count.astype(jnp.float32))
    new_count = history.count

    rep1 = rep2 = None
    if flags.temporal_filter:
        from .reproject import reproject_gather
        rep = reproject_gather(history.color, history.color2, history.depth,
                               history.mat_id, history.count, motion)
        rep1 = (rep.color, rep.depth, rep.mat_id, rep.count, rep.ok)
        rep2 = (rep.color2, rep.depth, rep.mat_id, rep.count, rep.ok)

    if flags.temporal_filter:
        c, new_count = temporal_filter(c, normal, depth, mat_id, motion,
                                       history.color, history.depth,
                                       history.mat_id, history.valid, p,
                                       hist_count=history.count, reproj=rep1)

    # noise estimate decays with accumulation (variance ~ 1/N), restoring
    # the reference's converged-tiles-skip-filtering behavior
    noise8 = tile_noise_level(c, depth, 8)
    if flags.temporal_filter:
        from ..ops.resize import box_pool
        n_tile = jnp.maximum(box_pool(new_count, 8), 1.0)
        noise8 = noise8 / n_tile

    if flags.spatial_filter:
        c = spatial_filter_7x7(c, normal, depth, mat_id, noise8, p,
                               frame_parity)

    hist_color = c  # "CopyToHistoryColorBuffer" point (denoising.cu order)

    if flags.spatial_filter:
        noise16 = tile_noise_downsample(tile_noise_level(c, depth, 8))
        for stride in (3, 6, 12):
            c = spatial_filter_wide(c, normal, depth, mat_id, noise16, p,
                                    stride)

    # remodulate albedo (reference: ApplyAlbedo, denoising.cu:160-163)
    from ..utils.debug import nan_guard
    c = nan_guard(c * albedo, "denoise.remodulated")

    if flags.second_temporal:
        c, _ = temporal_filter(c, normal, depth, mat_id, motion,
                               history.color2, history.depth,
                               history.mat_id, history.valid, p,
                               hist_count=history.count, reproj=rep2)
    hist_color2 = c

    store = ((lambda x: x.astype(jnp.bfloat16)) if flags.half_history
             else (lambda x: x))
    new_history = DenoiseHistory(
        color=store(hist_color), color2=store(hist_color2),
        depth=store(depth), mat_id=mat_id,
        valid=jnp.asarray(True), count=store(new_count))
    return c, new_history
