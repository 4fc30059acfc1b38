"""Mipmapped material textures with triplanar projection + ray-cone LOD.

Counterpart of the reference's texture stack: 11-level mip chains
of 1024^2 soil albedo+AO / normal+roughness textures
(reference: src/texture.h:14-25, mip generation src/mipgen.cu:121-182,
loading src/init.cu:524-580) sampled with triplanar mapping and bicubic
filtering with LOD from the ray-cone width
(reference: src/surfaceInteraction.cuh:75-164, src/sampler.cuh:392-594).

Re-architecture for XLA:
  * A mip *pyramid in one flat texel array* with static per-level offsets —
    per-pixel continuous LOD becomes pure index arithmetic + gathers, no
    per-level control flow.
  * Textures are generated procedurally at init (Perlin-derived soil albedo,
    AO, normal, roughness) instead of loaded from image assets, and the mip
    chain is a jitted 2x2 box-downsample reduce (mipgen analog).
  * Filtering: trilinear (bilinear x 2 mips).  The reference's bicubic
    smooth-step variant is available for the sky/history lookups in
    ops/resize.py; for triplanar terrain texturing trilinear is visually
    equivalent at our LOD bias and 3x cheaper in gathers.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..core.vecmath import normalize


class MipTexture(NamedTuple):
    """Flattened mip pyramid.  texels: (T, C); level l occupies
    [offsets[l], offsets[l] + size_l^2) rows, row-major (y * size_l + x)."""

    texels: jnp.ndarray    # (T, C) f32
    offsets: jnp.ndarray   # (L,) i32 static-size
    base_size: int         # python static: size of level 0 (power of two)

    @property
    def num_levels(self) -> int:
        return int(self.offsets.shape[0])


def build_mip_pyramid(img) -> MipTexture:
    """img: (S, S, C) float array (S power of two) -> full mip chain down to
    1x1 via 2x2 box filter (reference mipgen: src/mipgen.cu:121-182)."""
    img = jnp.asarray(img, jnp.float32)
    s = img.shape[0]
    assert (s & (s - 1)) == 0, "texture size must be a power of two"
    levels = [img]
    while levels[-1].shape[0] > 1:
        a = levels[-1]
        h = a.shape[0] // 2
        a = a.reshape(h, 2, h, 2, a.shape[-1]).mean(axis=(1, 3))
        levels.append(a)
    offsets = np.zeros(len(levels), np.int32)
    acc = 0
    for i, lv in enumerate(levels):
        offsets[i] = acc
        acc += lv.shape[0] * lv.shape[1]
    texels = jnp.concatenate([lv.reshape(-1, lv.shape[-1]) for lv in levels], axis=0)
    return MipTexture(texels, jnp.asarray(offsets), s)


def _bilinear_at_level(tex: MipTexture, uv, level):
    """Bilinear sample at integer mip `level` (...,) with repeat wrapping."""
    size = (tex.base_size >> level).astype(jnp.int32) if hasattr(level, "astype") \
        else tex.base_size >> level
    size = jnp.maximum(size, 1)
    off = tex.offsets[level]
    fs = size.astype(jnp.float32)
    x = uv[..., 0] * fs - 0.5
    y = uv[..., 1] * fs - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), size)
    x1i = jnp.mod(x0i + 1, size)
    y0i = jnp.mod(y0.astype(jnp.int32), size)
    y1i = jnp.mod(y0i + 1, size)
    base = off
    c00 = tex.texels[base + y0i * size + x0i]
    c01 = tex.texels[base + y0i * size + x1i]
    c10 = tex.texels[base + y1i * size + x0i]
    c11 = tex.texels[base + y1i * size + x1i]
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy


def sample_trilinear(tex: MipTexture, uv, lod):
    """Continuous-LOD trilinear sample; uv (...,2) repeat-wrapped, lod (...,)."""
    lmax = tex.num_levels - 1
    lod = jnp.clip(lod, 0.0, lmax)
    l0 = jnp.floor(lod).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, lmax)
    f = (lod - l0.astype(jnp.float32))[..., None]
    c0 = _bilinear_at_level(tex, uv, l0)
    c1 = _bilinear_at_level(tex, uv, l1)
    return c0 * (1 - f) + c1 * f


def triplanar_sample(tex: MipTexture, pos, n, cone_width, world_scale=0.25):
    """Triplanar projection sample with ray-cone LOD
    (reference: src/surfaceInteraction.cuh:75-164).

    pos (...,3) world hit position; n (...,3) shading normal;
    cone_width (...,) world-space ray cone footprint at the hit;
    world_scale: texture tiles per world unit.
    Returns (..., C).
    """
    # blend weights — sharpened |n| (reference uses pow-weighted blending)
    w = jnp.abs(n)
    w = w * w * w * w
    w = w / jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-8)

    # LOD: footprint in texel units at mip 0
    texels_per_unit = world_scale * tex.base_size
    lod = jnp.log2(jnp.maximum(cone_width * texels_per_unit, 1e-6))
    lod = jnp.maximum(lod, 0.0)

    uv_x = jnp.stack([pos[..., 1], pos[..., 2]], axis=-1) * world_scale
    uv_y = jnp.stack([pos[..., 0], pos[..., 2]], axis=-1) * world_scale
    uv_z = jnp.stack([pos[..., 0], pos[..., 1]], axis=-1) * world_scale
    uv_x = jnp.mod(uv_x, 1.0)
    uv_y = jnp.mod(uv_y, 1.0)
    uv_z = jnp.mod(uv_z, 1.0)

    cx = sample_trilinear(tex, uv_x, lod)
    cy = sample_trilinear(tex, uv_y, lod)
    cz = sample_trilinear(tex, uv_z, lod)
    return (w[..., 0:1] * cx + w[..., 1:2] * cy + w[..., 2:3] * cz)


# ---------------------------------------------------------------------------
# procedural soil material (init-time, numpy)
# ---------------------------------------------------------------------------


def _value_noise_2d(size, cells, seed, octaves=4):
    """Tileable multi-octave value noise, (size, size) in [0,1]."""
    rng = np.random.default_rng(seed)
    out = np.zeros((size, size), np.float32)
    amp = 1.0
    total = 0.0
    for o in range(octaves):
        c = cells * (2 ** o)
        grid = rng.uniform(0, 1, (c, c)).astype(np.float32)
        # bilinear upsample with wrap
        ys = (np.arange(size) + 0.5) / size * c - 0.5
        y0 = np.floor(ys).astype(int)
        fy = (ys - y0)[:, None]
        xs = ys
        x0 = np.floor(xs).astype(int)
        fx = (xs - x0)[None, :]
        g = lambda yy, xx: grid[np.mod(yy, c)[:, None], np.mod(xx, c)[None, :]]
        sm = lambda t: t * t * (3 - 2 * t)
        fy_s, fx_s = sm(fy), sm(fx)
        v = (g(y0, x0) * (1 - fy_s) + g(y0 + 1, x0) * fy_s) * (1 - fx_s) \
            + (g(y0, x0 + 1) * (1 - fy_s) + g(y0 + 1, x0 + 1) * fy_s) * fx_s
        out += amp * v
        total += amp
        amp *= 0.5
    return out / total


class SoilTextures(NamedTuple):
    """The framework's standard material texture set (soil albedo+AO and
    normal+roughness, analog of resources/textures consumed at
    src/init.cu:524-580)."""

    albedo_ao: MipTexture      # C=4: rgb albedo + ao
    normal_rough: MipTexture   # C=4: tangent-ish normal xyz + roughness


def make_soil_textures(size=1024, seed=7) -> SoilTextures:
    h = _value_noise_2d(size, 8, seed, octaves=6)          # height field
    detail = _value_noise_2d(size, 32, seed + 1, octaves=4)

    # albedo: blend of dirt browns by height + detail
    c_dark = np.array([0.23, 0.15, 0.09], np.float32)
    c_mid = np.array([0.42, 0.30, 0.18], np.float32)
    c_light = np.array([0.55, 0.47, 0.35], np.float32)
    t = np.clip(h[..., None] * 1.4 - 0.2, 0, 1)
    albedo = c_dark * (1 - t) + c_mid * t
    t2 = np.clip(detail[..., None] * 1.2 - 0.3, 0, 1)
    albedo = albedo * (1 - 0.4 * t2) + c_light * (0.4 * t2)

    # ambient occlusion from height (valleys darker)
    ao = np.clip(0.55 + 0.45 * h, 0, 1)[..., None].astype(np.float32)

    # normal from height gradient (y-up tangent space: n = normalize(-dx, s, -dy))
    scale = 3.0
    dx = (np.roll(h, -1, 1) - np.roll(h, 1, 1)) * 0.5 * size / 64.0
    dy = (np.roll(h, -1, 0) - np.roll(h, 1, 0)) * 0.5 * size / 64.0
    nrm = np.stack([-dx * scale, np.ones_like(h), -dy * scale], axis=-1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)

    rough = np.clip(0.55 + 0.4 * detail + 0.15 * (1 - h), 0.05, 1.0)[..., None]

    albedo_ao = np.concatenate([albedo, ao], axis=-1).astype(np.float32)
    normal_rough = np.concatenate([nrm, rough], axis=-1).astype(np.float32)
    return SoilTextures(build_mip_pyramid(albedo_ao),
                        build_mip_pyramid(normal_rough))


def apply_normal_map(n_geom, n_tex):
    """Perturb the geometric normal by a texture normal given in a y-up local
    frame, projected into the surface frame (triplanar-style cheap variant)."""
    from ..core.vecmath import orthonormal_basis
    t, b = orthonormal_basis(n_geom)
    n = (n_tex[..., 0:1] * t + n_tex[..., 2:3] * b
         + jnp.maximum(n_tex[..., 1:2], 0.2) * n_geom)
    return normalize(n)
