"""Edge-aware spatial filters: 7x7 gaussian + dilated (a-trous) 5x5 chain.

Counterpart of the reference's spatial denoisers
(reference: SpatialFilter7x7 at src/temporalDenoising.cuh:317-492 and
SpatialFilterGlobal5x5<stride> at :495+, launched with strides 3/6/12 from
src/denoising.cu:132-157).

Joint-bilateral weights per tap (reference :739-767):
    w = gauss(offset) * max(0, dot(n, n_tap))^sigma_normal
        * exp(-|z - z_tap|^2 / sigma_depth) * [mat == mat_tap penalty]

Structural difference: the reference *skips* quiet tiles (branchy); we
compute the filter everywhere and LERP by the noise gate — shape-static,
branch-free, and the XLA fusion makes the always-on cost close to the
gated one (SURVEY.md §7 stage-4 note).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops.stencil import gaussian_weights, neighborhood
from ..utils.config import DenoiseParams


def _edge_aware_pass(color, normal, depth, mat_id, p: DenoiseParams,
                     radius: int, stride: int, half_taps: bool = False,
                     parity: int = 0):
    """One joint-bilateral gaussian pass; returns filtered color.

    Tap-accumulation form: each tap is a statically shifted image fused
    into one multiply-add sweep, so XLA fuses the pass into a handful of
    sweeps over device memory instead of materializing a (K,H,W,C) tap
    stack."""
    from ..ops.stencil import shifted
    g = gaussian_weights(radius)
    k_half = (2 * radius + 1) ** 2 // 2
    safe_d = jnp.where(jnp.isfinite(depth), depth, 0.0)
    fin_d = jnp.isfinite(depth)
    inv_sig = 1.0 / (p.sigma_depth * jnp.maximum(safe_d, 1.0) + 1e-6)
    m_miss = jnp.maximum(1.0 - p.sigma_material, 0.0)

    wsum = jnp.zeros(depth.shape, jnp.float32)
    acc = jnp.zeros(color.shape, jnp.float32)
    k = -1
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            k += 1
            sy, sx = dy * stride, dx * stride
            c_t = shifted(color, sy, sx)
            n_t = shifted(normal, sy, sx)
            d_t = shifted(depth, sy, sx)
            m_t = shifted(mat_id, sy, sx)
            n_w = jnp.maximum(jnp.sum(n_t * normal, axis=-1), 0.0) \
                ** p.sigma_normal
            safe_dt = jnp.where(jnp.isfinite(d_t), d_t, 0.0)
            dz = (safe_dt - safe_d) * inv_sig
            d_w = jnp.exp(-dz * dz)
            d_w = jnp.where(jnp.isfinite(d_t) == fin_d, d_w, 0.0)
            m_w = jnp.where(m_t == mat_id, 1.0, m_miss)
            w = g[k] * n_w * d_w * m_w
            if half_taps and k != k_half:
                # traced parity: zero every other tap by (k+parity)%2
                keep_t = ((k + parity) % 2 == 0)
                w = w * jnp.where(keep_t, 1.0, 0.0)
            wsum = wsum + w
            acc = acc + c_t * w[..., None]

    out = acc / jnp.maximum(wsum, 1e-6)[..., None]
    # fall back to the center where weights vanish
    return jnp.where((wsum > 1e-6)[..., None], out, color)


def _upsample_tiles(noise, h, w, tile):
    """Nearest-upsample a tile map to (h, w), edge-padding the remainder
    rows/cols when the resolution is not a tile multiple."""
    up = jnp.repeat(jnp.repeat(noise, tile, axis=0), tile, axis=1)[:h, :w]
    pad_h, pad_w = h - up.shape[0], w - up.shape[1]
    if pad_h or pad_w:
        up = jnp.pad(up, ((0, pad_h), (0, pad_w)), mode="edge")
    return up


def _gate_by_noise(filtered, original, noise, threshold, tile: int):
    """Noise-level gating as a smooth lerp (branch-free static shape)."""
    h, w = original.shape[0], original.shape[1]
    up = _upsample_tiles(noise, h, w, tile)
    gate = jnp.clip(up / jnp.maximum(threshold, 1e-8), 0.0, 1.0)[..., None]
    return original + (filtered - original) * gate


def spatial_filter_7x7(color, normal, depth, mat_id, noise8, p: DenoiseParams,
                       frame_parity: int = 0):
    """The reference's SpatialFilter7x7: full 7x7 joint-bilateral, gated by
    the 8x8 tile noise level, alternating half-kernels per frame."""
    filtered = _edge_aware_pass(color, normal, depth, mat_id, p,
                                radius=3, stride=1, half_taps=True,
                                parity=frame_parity)
    return _gate_by_noise(filtered, color, noise8, p.noise_threshold, 8)


def spatial_filter_wide(color, normal, depth, mat_id, noise16,
                        p: DenoiseParams, stride: int):
    """The reference's SpatialFilterGlobal5x5<stride> (a-trous dilation):
    5x5 taps at the given stride (3/6/12 -> effective 15/30/60 px),
    gated by the 16x16 noise level."""
    filtered = _edge_aware_pass(color, normal, depth, mat_id, p,
                                radius=2, stride=stride)
    return _gate_by_noise(filtered, color, noise16, p.noise_threshold_16, 16)
