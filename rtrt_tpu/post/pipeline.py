"""Full post-processing chain: pyramid -> exposure -> bloom -> flare ->
tonemap -> upscale -> sharpen -> dither/quantize.

Counterpart of the reference's host chain (reference:
src/postprocessing.cu:5-161) and CopyToOutput (src/kernel.cu:26-59).
One fused jitted function; the exposure adaptation state threads through
as a (4,) array.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops.resize import downsample4, upscale_catmull_rom
from ..render.sampling import _to_unit_float, hash_pcg
from ..utils.config import FeatureFlags, PostParams
from .bloom import bloom
from .exposure import auto_exposure
from .lensflare import lens_flare
from .sharpen import sharpen
from .tonemap import tonemap


def postprocess(color, exposure_state, dt, sun_uv, sun_visible,
                p: PostParams, flags: FeatureFlags,
                out_h: int, out_w: int, frame_idx):
    """color: (H,W,3) linear denoised radiance at render res.

    Returns (u8 image (out_h,out_w,3), new_exposure_state).
    """
    h, w = color.shape[0], color.shape[1]

    # --- exposure (1/64-res histogram feed, reference DownScale4 x3;
    # stop early at tiny resolutions so the pyramid never hits zero) ---
    small = color
    for _ in range(3):
        if min(small.shape[0], small.shape[1]) >= 8:
            small = downsample4(small)
    if flags.auto_exposure:
        exposure_state = auto_exposure(small, exposure_state, dt,
                                       p.exposure_gain)
        ev = exposure_state[0]
        bright = exposure_state[2]
    else:
        ev = p.manual_exposure
        bright = 2.0 / jnp.maximum(p.manual_exposure, 1e-6)

    # --- bloom on pre-exposed linear color ---
    if flags.bloom:
        color = bloom(color, bright, p.bloom_strength)

    # --- lens flare (host-cond analog: visibility scalar) ---
    if flags.lens_flare:
        color = color + lens_flare(h, w, sun_uv, sun_visible,
                                   p.flare_strength) / jnp.maximum(ev, 1e-6)

    # --- exposure + tonemap + gamma ---
    exposed = color * ev
    ldr = tonemap(exposed, p.tone_map, p.gamma)

    # --- upscale to screen res (Catmull-Rom) ---
    if (out_h, out_w) != (h, w):
        ldr = jnp.clip(upscale_catmull_rom(ldr, out_h, out_w), 0.0, 1.0)

    # --- sharpen ---
    if flags.sharpen:
        ldr = sharpen(ldr, p.sharpen_amount)

    # --- dither + quantize (reference: CopyToOutput blue-noise dither,
    # src/kernel.cu:26-59) — the tiled void-and-cluster mask, toroidally
    # shifted per frame so banding breakup also averages out temporally ---
    if flags.dither:
        from ..render.sampling import blue_noise_mask
        m = jnp.asarray(blue_noise_mask()[:, :, 0])
        reps_y = -(-out_h // m.shape[0])
        reps_x = -(-out_w // m.shape[1])
        tiled = jnp.tile(m, (reps_y, reps_x))[:out_h, :out_w]
        fshift = _to_unit_float(
            hash_pcg(jnp.asarray(frame_idx).astype(jnp.uint32)))
        noise = (tiled + fshift) % 1.0 - 0.5
        ldr = ldr + noise[..., None] / 255.0
    u8 = jnp.clip(ldr * 255.0 + 0.5, 0.0, 255.0).astype(jnp.uint8)
    return u8, exposure_state
