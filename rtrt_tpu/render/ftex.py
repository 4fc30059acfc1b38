"""Fourier-fitted textures: image-derived materials without texel fetches.

The reference samples mipmapped image textures inside its path-trace
megakernel (triplanar projection, bicubic, ray-cone LOD —
reference: src/surfaceInteraction.cuh:75-164, src/texture.h:14-25,
src/mipgen.cu:121-182); every texel fetch is a per-lane gather.

This module takes another route: project the texture onto a truncated 2-D
Fourier basis at load time (host lstsq) and evaluate the series
analytically — dense arithmetic, zero gathers, and the mip chain becomes
EXACT analytic prefiltering: a Gaussian footprint of std sigma (in tile
units) multiplies the coefficient of frequency f by exp(-2 pi^2 |f|^2
sigma^2), so ray-cone LOD is one exponential per term instead of a mip
ladder.  This is the same move the sky made (Chebyshev env fit) applied
to materials.  The band limit (top-K frequencies) is the quality
trade-off; K~24 reproduces the soil material set faithfully (see
tests/test_ftex.py for the fit-error gates).

The classic gather-based mip/triplanar pipeline (render/texture.py) is the
fit's ground truth.  Only the component-form shading twin
(render/megakernel.py) reads these fits; the frame does not.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class FourierTexture(NamedTuple):
    """Truncated 2-D Fourier model of one (tileable) texture.

    value(u, v) = mean + sum_k weight[k] * cos(2 pi (fx u + fy v) + phase)
    with (u, v) in tile units (period 1).  All fields are nested float
    TUPLES — hashable, so the texture rides FrameStatic as a static jit
    argument and every coefficient folds into the compiled kernel as an
    immediate (a traced array here would turn the analytic eval into
    per-term gathers)."""

    freq: tuple    # K x (fx, fy) integer cycles/tile
    phase: tuple   # K floats
    weight: tuple  # K x C floats
    mean: tuple    # C floats


def _atoms(max_freq):
    """Dictionary of (fx, fy, phase) atoms covering all orientations once:
    fx in [0..F], fy in [-F..F], excluding (0,0) and the fy<0 half of the
    fx==0 column (cos is even — those duplicate)."""
    out = []
    for fx in range(max_freq + 1):
        for fy in range(-max_freq, max_freq + 1):
            if fx == 0 and fy <= 0:
                continue
            out.append((fx, fy))
    return out


def fit_fourier_texture(img, n_terms=24, max_freq=8) -> FourierTexture:
    """Least-squares fit of an (S, S, C) [tileable] image.

    Two-stage: lstsq over the full cos/sin dictionary on a subsampled
    grid, keep the top n_terms frequencies by energy, refit those."""
    img = np.asarray(img, np.float32)
    s = img.shape[0]
    sub = max(1, s // 128)
    im = img[::sub, ::sub].reshape(-1, img.shape[-1]).astype(np.float64)
    n = img[::sub, ::sub].shape[0]
    yy, xx = np.meshgrid((np.arange(n) + 0.5) / n,
                         (np.arange(n) + 0.5) / n, indexing="ij")
    u = xx.reshape(-1)
    v = yy.reshape(-1)

    mean = im.mean(axis=0)
    resid = im - mean

    atoms = _atoms(max_freq)
    cols = []
    for fx, fy in atoms:
        ang = 2 * np.pi * (fx * u + fy * v)
        cols.append(np.cos(ang))
        cols.append(np.sin(ang))
    a = np.stack(cols, axis=1)                      # (N, 2K0)
    w, *_ = np.linalg.lstsq(a, resid, rcond=None)   # (2K0, C)

    # cos+sin pair k -> amplitude + phase per atom; rank by total energy
    wc = w[0::2]
    ws = w[1::2]
    amp2 = (wc ** 2 + ws ** 2).sum(axis=1)
    keep = np.argsort(amp2)[::-1][:n_terms]

    # refit the kept atoms (both phases) for the final weights
    cols = []
    for k in keep:
        fx, fy = atoms[k]
        ang = 2 * np.pi * (fx * u + fy * v)
        cols.append(np.cos(ang))
        cols.append(np.sin(ang))
    a2 = np.stack(cols, axis=1)
    w2, *_ = np.linalg.lstsq(a2, resid, rcond=None)
    wc = w2[0::2]
    ws = w2[1::2]
    # A cos(x) + B sin(x) = R cos(x + p): per-atom single phase would
    # couple channels; keep cos AND sin as separate terms instead so each
    # term stays a plain weighted cosine (sin via phase -pi/2)
    freq = []
    phase = []
    weight = []
    for i, k in enumerate(keep):
        fx, fy = atoms[k]
        freq.append((float(fx), float(fy)))
        phase.append(0.0)
        weight.append(tuple(float(x) for x in wc[i]))
        freq.append((float(fx), float(fy)))
        phase.append(-float(np.pi / 2.0))
        weight.append(tuple(float(x) for x in ws[i]))
    return FourierTexture(tuple(freq), tuple(phase), tuple(weight),
                          tuple(float(x) for x in mean))


def eval_fourier_np(tex: FourierTexture, u, v, sigma=0.0):
    """Numpy oracle of the kernel evaluation (tests)."""
    u = np.asarray(u, np.float64)[..., None]
    v = np.asarray(v, np.float64)[..., None]
    freq = np.asarray(tex.freq, np.float64)
    fx = freq[:, 0]
    fy = freq[:, 1]
    ang = 2 * np.pi * (fx * u + fy * v) + np.asarray(tex.phase)
    att = np.exp(-2 * np.pi ** 2 * (fx ** 2 + fy ** 2) * float(sigma) ** 2)
    basis = np.cos(ang) * att                       # (..., K)
    return np.asarray(tex.mean) + basis @ np.asarray(tex.weight)


def eval_fourier_c(tex: FourierTexture, u, v, sigma):
    """Component-form jnp evaluation (megakernel path): u, v, sigma are
    same-shape component arrays; returns a list of C channel arrays.
    All texture constants fold into the program as scalars."""
    import jax.numpy as jnp

    k = len(tex.freq)
    c = len(tex.weight[0]) if k else len(tex.mean)
    two_pi = 2.0 * np.pi
    s2 = sigma * sigma
    acc = [jnp.zeros_like(u) + float(tex.mean[ci]) for ci in range(c)]
    for i in range(k):
        fx = float(tex.freq[i][0])
        fy = float(tex.freq[i][1])
        f2 = fx * fx + fy * fy
        ang = (two_pi * fx) * u + (two_pi * fy) * v + float(tex.phase[i])
        term = jnp.cos(ang) * jnp.exp((-2.0 * np.pi ** 2 * f2) * s2)
        for ci in range(c):
            w = float(tex.weight[i][ci])
            if w != 0.0:
                acc[ci] = acc[ci] + w * term
    return acc


def triplanar_fourier_c(tex: FourierTexture, pos, ns, cone_w,
                        world_scale=0.25):
    """Triplanar Fourier sampling in component form (kernel-safe).

    pos/ns: V3 component tuples; cone_w: footprint at the hit (world
    units).  Mirrors render/texture.py::triplanar_sample's projection and
    LOD convention; sigma = half the footprint in tile units."""
    import jax.numpy as jnp

    ax = jnp.abs(ns.x)
    ay = jnp.abs(ns.y)
    az = jnp.abs(ns.z)
    wx = ax * ax * ax * ax
    wy = ay * ay * ay * ay
    wz = az * az * az * az
    inv = 1.0 / jnp.maximum(wx + wy + wz, 1e-8)

    sigma = jnp.maximum(cone_w, 0.0) * (world_scale * 0.5)
    cx = eval_fourier_c(tex, pos.y * world_scale, pos.z * world_scale, sigma)
    cy = eval_fourier_c(tex, pos.x * world_scale, pos.z * world_scale, sigma)
    cz = eval_fourier_c(tex, pos.x * world_scale, pos.y * world_scale, sigma)
    return [(wx * a + wy * b + wz * c) * inv
            for a, b, c in zip(cx, cy, cz)]


def ftex_shading_c(ftex, pos, ns, cone_width, world_scale=0.25):
    """Image-derived material shading in component form — the
    soil_shading_c interface (-> albedo*ao V3, rough, normal V3) backed by
    the FITTED texture set instead of procedural noise.  This is the
    megakernel's textured-material path (reference:
    src/surfaceInteraction.cuh:75-164 does the same three lookups from its
    mip atlas)."""
    import jax.numpy as jnp

    from .kshade import V3, orthonormal_basis_c, vnormalize

    a = triplanar_fourier_c(ftex.albedo_ao, pos, ns, cone_width,
                            world_scale)            # [r, g, b, ao]
    nr = triplanar_fourier_c(ftex.normal_rough, pos, ns, cone_width,
                             world_scale)           # [nx, ny, nz, rough]
    ao = jnp.clip(a[3], 0.0, 1.0)
    alb = V3(jnp.clip(a[0], 0.0, 1.0) * ao,
             jnp.clip(a[1], 0.0, 1.0) * ao,
             jnp.clip(a[2], 0.0, 1.0) * ao)
    rough = jnp.clip(nr[3], 0.05, 1.0)
    # texture.apply_normal_map in component form: texture normal is y-up
    # local; project into the surface frame
    t, b = orthonormal_basis_c(ns)
    n2 = t * nr[0] + b * nr[2] + ns * jnp.maximum(nr[1], 0.2)
    return alb, rough, vnormalize(n2)


class FourierTextures(NamedTuple):
    """The fitted material set (albedo+AO, normal+roughness) — the
    megakernel twin of texture.SoilTextures."""

    albedo_ao: FourierTexture
    normal_rough: FourierTexture


def fit_soil_fourier(soil, n_terms=24, max_freq=8) -> FourierTextures:
    """Fit the level-0 mips of a SoilTextures set (render/texture.py)."""
    def level0(mip):
        s = mip.base_size
        return np.asarray(mip.texels[:s * s]).reshape(s, s, -1)

    return FourierTextures(
        fit_fourier_texture(level0(soil.albedo_ao), n_terms, max_freq),
        fit_fourier_texture(level0(soil.normal_rough), n_terms, max_freq))
