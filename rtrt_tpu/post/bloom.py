"""Bloom: bright-pass + gaussian pyramid blur + smoothed composite.

Counterpart of the reference's bloom (reference: BloomGuassian at
src/postprocessing.cuh:348-390 on the 1/4 and 1/16 buffers, composite
`Bloom` :392-410 adding 0.05 * (bicubic(1/4) + bicubic(1/16))).

Design note: the reference's bicubic upscale is 16 gather taps per level;
bloom is low-frequency by construction, so ALL smoothing happens at the
low resolutions and the upsample back to full res is a dense-matmul
bilinear resize (ops/resize.py::upsample_linear — zero gathers), visually
identical for a low-frequency signal and far cheaper than a full-res 5x5
smooth, whose taps materialize 25 full-res planes.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.color import luminance
from ..ops.resize import downsample4, upsample_linear
from ..ops.stencil import gaussian_weights, neighborhood


def _gauss5(img):
    w = gaussian_weights(2)
    taps, _ = neighborhood(img, 2)
    return jnp.sum(taps * w[:, None, None, None], axis=0)


def bright_pass(img, threshold):
    lum = luminance(img)[..., None]
    scale = jnp.clip((lum - threshold) / jnp.maximum(threshold, 1e-4), 0.0, 1.0)
    return img * scale


def bloom(img, bright_lum, strength):
    """img: (H,W,3) pre-tonemap linear color; bright_lum: adaptation bright
    luminance (threshold source, reference reads exposure[2]); strength:
    composite weight (reference 0.05)."""
    quarter = downsample4(img)
    sixteenth = downsample4(quarter)
    q = _gauss5(bright_pass(quarter, bright_lum))
    s = _gauss5(_gauss5(bright_pass(sixteenth, bright_lum)))
    h, w = img.shape[0], img.shape[1]
    q_up = upsample_linear(q, h, w)
    s_up = upsample_linear(s, h, w)
    return img + strength * (q_up + s_up)
