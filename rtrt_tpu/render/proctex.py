"""Analytic procedural material texturing — zero-gather terrain shading.

Replaces gathered mipmapped triplanar texture fetches for the terrain
material (reference: src/surfaceInteraction.cuh:75-164 samples soil
albedo/AO/normal/roughness textures with bicubic LOD) with 3D value noise
evaluated IN CLOSED FORM at the shading point: per-lane hashes + trilinear
lattice interpolation are pure arithmetic, so texturing costs no memory
traffic at all.  LOD filtering is analytic too: each octave's amplitude
fades as the ray-cone footprint exceeds its wavelength (the integral of the
noise over the footprint tends to its mean), which is exactly what a mip
chain approximates.

The table-based mip/triplanar path (render/texture.py) remains available
for imported image textures.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.vecmath import normalize

U32 = jnp.uint32


def _hash3(ix, iy, iz, seed):
    """Lattice hash -> [0,1) float; inputs int32 arrays."""
    h = (ix.astype(U32) * U32(0x8DA6B343)
         ^ iy.astype(U32) * U32(0xD8163841)
         ^ iz.astype(U32) * U32(0xCB1AB31F)) + U32(seed)
    h ^= h >> 15
    h *= U32(0x2C1B3C6D)
    h ^= h >> 12
    h *= U32(0x297A2D39)
    h ^= h >> 15
    # top-24-bit unit float via an i32->f32 convert (exact in f32's
    # mantissa; the component-form twin shares this hash)
    return (h >> 8).astype(jnp.int32).astype(jnp.float32) \
        * jnp.float32(5.960464477539063e-08)


def value_noise3(p, seed: int):
    """Single-octave 3D value noise in [0,1]; p (...,3) world coords."""
    pf = jnp.floor(p)
    ix = pf[..., 0].astype(jnp.int32)
    iy = pf[..., 1].astype(jnp.int32)
    iz = pf[..., 2].astype(jnp.int32)
    f = p - pf
    # quintic smoothstep
    w = f * f * f * (f * (f * 6.0 - 15.0) + 10.0)
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]

    def h(dx, dy, dz):
        return _hash3(ix + dx, iy + dy, iz + dz, seed)

    c000 = h(0, 0, 0)
    c100 = h(1, 0, 0)
    c010 = h(0, 1, 0)
    c110 = h(1, 1, 0)
    c001 = h(0, 0, 1)
    c101 = h(1, 0, 1)
    c011 = h(0, 1, 1)
    c111 = h(1, 1, 1)
    x00 = c000 + (c100 - c000) * wx
    x10 = c010 + (c110 - c010) * wx
    x01 = c001 + (c101 - c001) * wx
    x11 = c011 + (c111 - c011) * wx
    y0 = x00 + (x10 - x00) * wy
    y1 = x01 + (x11 - x01) * wy
    return y0 + (y1 - y0) * wz


def fbm3_filtered(p, cone_width, octaves: int, base_freq: float, seed: int,
                  gain: float = 0.5):
    """Analytic-LOD fractal noise: octave k at frequency f_k fades out once
    the footprint covers its wavelength (returns to the mean 0.5)."""
    total = jnp.zeros(p.shape[:-1], jnp.float32)
    norm = 0.0
    amp = 1.0
    freq = base_freq
    for k in range(octaves):
        fade = jnp.clip(1.0 - cone_width * freq * 1.5, 0.0, 1.0)
        n = value_noise3(p * freq, seed + k * 131)
        total = total + amp * (0.5 + (n - 0.5) * fade)
        norm += amp
        amp *= gain
        freq *= 2.0
    return total / norm


def soil_shading(pos, ns, cone_width, world_scale: float = 0.35):
    """Full soil material: (albedo*ao (...,3), roughness (...), perturbed
    normal (...,3)) — the procedural twin of the reference's triplanar
    soil texture set, ~150 ops/lane, zero gathers."""
    p = pos * world_scale
    h = fbm3_filtered(p, cone_width * world_scale, 4, 1.0, seed=101)
    detail = fbm3_filtered(p, cone_width * world_scale, 3, 6.0, seed=202)

    c_dark = jnp.array([0.23, 0.15, 0.09], jnp.float32)
    c_mid = jnp.array([0.42, 0.30, 0.18], jnp.float32)
    c_light = jnp.array([0.55, 0.47, 0.35], jnp.float32)
    t = jnp.clip(h * 1.4 - 0.2, 0.0, 1.0)[..., None]
    albedo = c_dark * (1.0 - t) + c_mid * t
    t2 = jnp.clip(detail * 1.2 - 0.3, 0.0, 1.0)[..., None]
    albedo = albedo * (1.0 - 0.4 * t2) + c_light * (0.4 * t2)
    ao = jnp.clip(0.55 + 0.45 * h, 0.0, 1.0)[..., None]

    rough = jnp.clip(0.55 + 0.4 * detail + 0.15 * (1.0 - h), 0.05, 1.0)

    # normal perturbation: independent noise vector, LOD-faded
    bump_fade = jnp.clip(1.0 - cone_width * world_scale * 8.0, 0.0, 1.0)
    bx = fbm3_filtered(p + 17.17, cone_width * world_scale, 2, 5.0, seed=303)
    by = fbm3_filtered(p + 29.29, cone_width * world_scale, 2, 5.0, seed=404)
    bz = fbm3_filtered(p + 43.43, cone_width * world_scale, 2, 5.0, seed=505)
    bump = jnp.stack([bx - 0.5, by - 0.5, bz - 0.5], axis=-1)
    n2 = normalize(ns + bump * (0.8 * bump_fade)[..., None])
    return albedo * ao, rough, n2
