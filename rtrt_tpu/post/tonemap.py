"""Tone-mapping operators: Reinhard extended, ACES (fitted + approx),
Uncharted2 — selected at runtime by a traced index.

Counterpart of the reference's four tone mappers
(reference: src/postprocessing.cuh:493-713, dispatch at
src/postprocessing.cu:125-159).  The operators are the standard published
curves (Reinhard 2002; Hill/Day ACES fits; Hable's filmic).  Runtime
selection is a branchless 4-way select (`jnp.where` chain) so switching
never recompiles the frame.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.color import luminance

_HIGHEST = jax.lax.Precision.HIGHEST

TONE_REINHARD = 0
TONE_ACES_FITTED = 1
TONE_ACES_APPROX = 2
TONE_UNCHARTED2 = 3


def reinhard_extended(c, white=4.0):
    """Luminance-based extended Reinhard (clamped: inputs beyond the white
    point would otherwise map above 1)."""
    lum = luminance(c)[..., None]
    num = lum * (1.0 + lum / (white * white))
    mapped = num / (1.0 + lum)
    return jnp.clip(c * (mapped / jnp.maximum(lum, 1e-6)), 0.0, 1.0)


# ACES fitted (Stephen Hill's RRT+ODT fit): sRGB->ACES-ish input/output mats
_ACES_IN = jnp.array([
    [0.59719, 0.35458, 0.04823],
    [0.07600, 0.90834, 0.01566],
    [0.02840, 0.13383, 0.83777],
], jnp.float32)
_ACES_OUT = jnp.array([
    [1.60475, -0.53108, -0.07367],
    [-0.10208, 1.10813, -0.00605],
    [-0.00327, -0.07276, 1.07602],
], jnp.float32)


def aces_fitted(c):
    # full float32 (no TF32 on a GPU): the products feed the 8-bit output
    v = jnp.einsum("ij,...j->...i", _ACES_IN, c, precision=_HIGHEST)
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    v = a / b
    return jnp.clip(jnp.einsum("ij,...j->...i", _ACES_OUT, v,
                               precision=_HIGHEST), 0.0, 1.0)


def aces_approx(c):
    """Krzysztof Narkowicz's cheap ACES curve."""
    c = c * 0.6
    a, b, d, e, f = 2.51, 0.03, 2.43, 0.59, 0.14
    return jnp.clip((c * (a * c + b)) / (c * (d * c + e) + f), 0.0, 1.0)


def _hable(x):
    a, b, c_, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (a * x + c_ * b) + d * e) / (x * (a * x + b) + d * f)) - e / f


def uncharted2(c, white=11.2):
    return jnp.clip(_hable(c * 2.0) / _hable(jnp.full_like(c, white)), 0.0, 1.0)


def tonemap(c, tone_index, gamma=2.2):
    """Apply the selected operator then gamma encode.  `tone_index` is a
    traced float/int scalar: branchless select over all four curves."""
    t0 = reinhard_extended(c)
    t1 = aces_fitted(c)
    t2 = aces_approx(c)
    t3 = uncharted2(c)
    i = jnp.round(tone_index)
    out = jnp.where(i == TONE_REINHARD, t0,
                    jnp.where(i == TONE_ACES_FITTED, t1,
                              jnp.where(i == TONE_ACES_APPROX, t2, t3)))
    return jnp.power(jnp.clip(out, 0.0, 1.0), 1.0 / gamma)
