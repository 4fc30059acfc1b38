"""Color-science transforms (XYZ / sRGB / ACES / YCoCg / luminance).

Counterpart of the reference's color matrices
(reference: src/color.h:6-48) and the denoiser's YCoCg transform
(reference: src/temporalDenoising.cuh:10-30).  Matrices are the standard
published CIE / ACES colorimetry constants.

All functions map (..., 3) float arrays -> (..., 3).
"""

from __future__ import annotations

import jax.numpy as jnp

from .vecmath import matvec

# CIE XYZ (D65) -> linear sRGB (IEC 61966-2-1)
XYZ_TO_SRGB = jnp.array([
    [3.2404542, -1.5371385, -0.4985314],
    [-0.9692660, 1.8760108, 0.0415560],
    [0.0556434, -0.2040259, 1.0572252],
], jnp.float32)

SRGB_TO_XYZ = jnp.array([
    [0.4124564, 0.3575761, 0.1804375],
    [0.2126729, 0.7151522, 0.0721750],
    [0.0193339, 0.1191920, 0.9503041],
], jnp.float32)

# XYZ -> ACES2065-1 (AP0, from the ACES spec)
XYZ_TO_ACES2065 = jnp.array([
    [1.0498110175, 0.0000000000, -0.0000974845],
    [-0.4959030231, 1.3733130458, 0.0982400361],
    [0.0000000000, 0.0000000000, 0.9912520182],
], jnp.float32)

# linear sRGB <-> ACEScg (AP1) fits (standard Blackmagic/ACES constants)
SRGB_TO_ACESCG = jnp.array([
    [0.6131, 0.3395, 0.0474],
    [0.0702, 0.9164, 0.0134],
    [0.0206, 0.1096, 0.8698],
], jnp.float32)

ACESCG_TO_SRGB = jnp.array([
    [1.7049, -0.6217, -0.0832],
    [-0.1302, 1.1408, -0.0106],
    [-0.0240, -0.1289, 1.1529],
], jnp.float32)

# Rec.709 luminance weights
LUMA = jnp.array([0.2126, 0.7152, 0.0722], jnp.float32)


def xyz_to_srgb(c):
    return matvec(XYZ_TO_SRGB, c)


def srgb_to_xyz(c):
    return matvec(SRGB_TO_XYZ, c)


def xyz_to_aces2065(c):
    return matvec(XYZ_TO_ACES2065, c)


def srgb_to_acescg(c):
    return matvec(SRGB_TO_ACESCG, c)


def acescg_to_srgb(c):
    return matvec(ACESCG_TO_SRGB, c)


def luminance(c):
    """Rec.709 relative luminance of linear RGB: (...,3) -> (...,)."""
    return jnp.sum(c * LUMA, axis=-1)


def rgb_to_ycocg(c):
    """RGB -> YCoCg (orthogonal variant used for history clamping)."""
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    y = 0.25 * r + 0.5 * g + 0.25 * b
    co = 0.5 * r - 0.5 * b
    cg = -0.25 * r + 0.5 * g - 0.25 * b
    return jnp.stack([y, co, cg], axis=-1)


def ycocg_to_rgb(c):
    y, co, cg = c[..., 0], c[..., 1], c[..., 2]
    r = y + co - cg
    g = y + cg
    b = y - co - cg
    return jnp.stack([r, g, b], axis=-1)


def linear_to_srgb_gamma(c):
    """Linear -> sRGB transfer function (piecewise)."""
    c = jnp.clip(c, 0.0, 1.0)
    return jnp.where(c <= 0.0031308, 12.92 * c, 1.055 * jnp.power(c, 1.0 / 2.4) - 0.055)


def srgb_gamma_to_linear(c):
    c = jnp.clip(c, 0.0, 1.0)
    return jnp.where(c <= 0.04045, c / 12.92, jnp.power((c + 0.055) / 1.055, 2.4))
