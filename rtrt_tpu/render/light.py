"""Light sampling: environment (sky + sun) importance sampling + sphere lights.

Counterpart of the reference's light system
(reference: src/light.cuh — flux-weighted sky-vs-sun selection :150-161,
inverse-CDF sampling :10-31/:182/:207, PDF from CDF differences :185-213,
sphere-light cone sampling :240-270, escaped-ray radiance resolve
GetLightSource :275-305).

XLA-first choices: the inverse CDF is `jnp.searchsorted` over the baked
luminance CDFs (no binary-search kernels), and because the sky map is exact
equal-area, solid-angle PDFs are simply texel-probability / texel-solid-angle
with no sin(theta) terms.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core.color import luminance
from ..core.vecmath import dot, normalize, orthonormal_basis
from .sampling import uniform_cone, uniform_cone_pdf
from .sky import (SKY_RES, SUN_ANGULAR_RADIUS, SUN_COS_THETA_MAX, SUN_RES,
                  SkyMaps, dir_to_equal_area_uv, equal_area_uv_to_dir,
                  sky_radiance, texel_solid_angle)


class LightSample(NamedTuple):
    wi: jnp.ndarray        # (...,3) direction to light
    radiance: jnp.ndarray  # (...,3) incident radiance if unoccluded
    pdf: jnp.ndarray       # (...,) solid-angle pdf of this sample
    dist: jnp.ndarray      # (...,) distance to light (inf for env)


# ---------------------------------------------------------------------------
# environment light
# ---------------------------------------------------------------------------


def _sample_map_cdf(cdf, u):
    """Inverse-CDF texel selection: cdf (T,) inclusive; u (...,) in [0,1)."""
    return jnp.clip(jnp.searchsorted(cdf, u, side="right"), 0, cdf.shape[0] - 1)


def _texel_prob(cdf, idx):
    """Discrete probability of texel idx under an inclusive CDF."""
    prev = jnp.where(idx > 0, cdf[jnp.maximum(idx - 1, 0)], 0.0)
    return cdf[idx] - prev


def _sun_uv_to_dir(maps: SkyMaps, uv):
    """Map sun-cone-map uv in [0,1)^2 to a world direction."""
    sx = uv[..., 0] * 2.0 - 1.0
    sy = uv[..., 1] * 2.0 - 1.0
    sin_a = jnp.sin(jnp.float32(SUN_ANGULAR_RADIUS))
    tang = sx[..., None] * maps.sun_basis_t + sy[..., None] * maps.sun_basis_b
    r2 = jnp.clip(sx * sx + sy * sy, 0.0, 1.0)
    axial = jnp.sqrt(jnp.maximum(1.0 - r2 * sin_a * sin_a, 0.0))
    return normalize(axial[..., None] * maps.sun_dir + sin_a * tang)


def _alias_pick(alias_p, alias_j, u1, u2):
    """O(1) Walker alias sampling: 2 single-element gathers per sample."""
    n = alias_p.shape[0]
    k = jnp.clip((u1 * n).astype(jnp.int32), 0, n - 1)
    accept = u2 < alias_p[k]
    return jnp.where(accept, k, alias_j[k])


def sample_env_light(maps: SkyMaps, u3) -> LightSample:
    """Importance-sample the environment: flux-weighted sky-vs-sun choice,
    then O(1) alias-table texel selection + in-texel jitter.

    Replaces the reference's binary-searched CDF inversion
    (src/light.cuh:10-31): the 17-probe searchsorted becomes a 2-gather
    alias lookup.

    u3: (...,3) uniform randoms (selector, table, accept/jitter).
    """
    h, w = maps.sky_map.shape[0], maps.sky_map.shape[1]
    sh, sw = maps.sun_map.shape[0], maps.sun_map.shape[1]
    total = maps.sky_flux + maps.sun_flux
    p_sun = jnp.where(total > 0, maps.sun_flux / jnp.maximum(total, 1e-20), 0.0)
    pick_sun = u3[..., 0] < p_sun

    jx = jnp.mod(u3[..., 2] * 7919.0, 1.0)
    jy = jnp.mod(u3[..., 2] * 104729.0, 1.0)
    u_accept = jnp.mod(u3[..., 2] * 15485863.0, 1.0)

    # --- sky branch ---
    sky_idx = _alias_pick(maps.sky_alias_p, maps.sky_alias_j,
                          u3[..., 1], u_accept)
    iy = (sky_idx // w).astype(jnp.float32)
    ix = (sky_idx % w).astype(jnp.float32)
    sky_uv = jnp.stack([(ix + jx) / w, (iy + jy) / h], axis=-1)
    sky_dir = equal_area_uv_to_dir(sky_uv)
    sky_rad = maps.sky_map[(sky_idx // w), (sky_idx % w)]
    sky_pdf_sa = maps.sky_pdf[sky_idx]

    # --- sun branch ---
    sun_idx = _alias_pick(maps.sun_alias_p, maps.sun_alias_j,
                          u3[..., 1], u_accept)
    siy = (sun_idx // sw).astype(jnp.float32)
    six = (sun_idx % sw).astype(jnp.float32)
    sun_uv = jnp.stack([(six + jx) / sw, (siy + jy) / sh], axis=-1)
    sun_dir = _sun_uv_to_dir(maps, sun_uv)
    sun_rad = maps.sun_map[(sun_idx // sw), (sun_idx % sw)]
    sun_pdf_sa = maps.sun_pdf[sun_idx]

    wi = jnp.where(pick_sun[..., None], sun_dir, sky_dir)
    rad = jnp.where(pick_sun[..., None], sun_rad, sky_rad)
    # mixture pdf (the sky map excludes the sun disk radiance so the two
    # strategies barely overlap)
    pdf = jnp.where(pick_sun, p_sun * sun_pdf_sa, (1.0 - p_sun) * sky_pdf_sa)
    inf = jnp.full(wi.shape[:-1], jnp.inf, jnp.float32)
    return LightSample(wi, rad, jnp.maximum(pdf, 0.0), inf)


def env_light_pdf(maps: SkyMaps, d):
    """Solid-angle pdf that `sample_env_light` generates direction d — used
    for MIS weighting of BSDF rays that escape to the sky
    (reference: pdf-from-CDF lookups, src/light.cuh:185-213)."""
    h, w = maps.sky_map.shape[0], maps.sky_map.shape[1]
    total = maps.sky_flux + maps.sun_flux
    p_sun = jnp.where(total > 0, maps.sun_flux / jnp.maximum(total, 1e-20), 0.0)

    uv = dir_to_equal_area_uv(d)
    ix = jnp.clip((uv[..., 0] * w).astype(jnp.int32), 0, w - 1)
    iy = jnp.clip((uv[..., 1] * h).astype(jnp.int32), 0, h - 1)
    idx = iy * w + ix
    sky_pdf = maps.sky_pdf[idx]

    # sun contribution only within the cone
    cos_g = dot(d, jnp.broadcast_to(maps.sun_dir, d.shape))
    in_cone = cos_g > SUN_COS_THETA_MAX
    sh, sw = maps.sun_map.shape[0], maps.sun_map.shape[1]
    sin_a = jnp.sin(jnp.float32(SUN_ANGULAR_RADIUS))
    tx = dot(d, jnp.broadcast_to(maps.sun_basis_t, d.shape)) / sin_a
    ty = dot(d, jnp.broadcast_to(maps.sun_basis_b, d.shape)) / sin_a
    sxi = jnp.clip(((tx + 1.0) * 0.5 * sw).astype(jnp.int32), 0, sw - 1)
    syi = jnp.clip(((ty + 1.0) * 0.5 * sh).astype(jnp.int32), 0, sh - 1)
    sidx = syi * sw + sxi
    sun_pdf = jnp.where(in_cone, maps.sun_pdf[sidx], 0.0)
    return (1.0 - p_sun) * sky_pdf + p_sun * sun_pdf


def env_radiance(maps: SkyMaps, d):
    """Radiance for escaped rays (GetLightSource analog)."""
    return sky_radiance(maps, d)


# ---------------------------------------------------------------------------
# analytic sun NEE — the integrator's zero-gather light path
# ---------------------------------------------------------------------------


def sample_sun(maps: SkyMaps, u2) -> LightSample:
    """Uniform-cone sample of the sun disk with fully ANALYTIC radiance and
    pdf (limb-darkened disk x transmittance; cone pdf in closed form).

    This is the preferred NEE strategy here: the smooth Rayleigh sky is
    efficiently covered by BSDF sampling + MIS, so next-event estimation
    only needs the quasi-delta sun — and that requires no table gathers at
    all (cf. the reference's CDF maps, src/light.cuh:150-213)."""
    from .sky import sun_disk_radiance
    cos_max = jnp.float32(SUN_COS_THETA_MAX)
    local = uniform_cone(u2, cos_max)
    t, b = maps.sun_basis_t, maps.sun_basis_b
    wi = normalize(local[..., 0:1] * t + local[..., 1:2] * b
                   + local[..., 2:3] * maps.sun_dir)
    rad = sun_disk_radiance(maps, wi)
    pdf = jnp.broadcast_to(uniform_cone_pdf(cos_max), wi.shape[:-1])
    inf = jnp.full(wi.shape[:-1], jnp.inf, jnp.float32)
    # below-horizon sun contributes nothing
    up = maps.sun_dir[1] > -0.05
    rad = jnp.where(up, rad, 0.0)
    return LightSample(wi, rad, pdf, inf)


def sun_pdf_dir(maps: SkyMaps, d):
    """Analytic pdf that `sample_sun` produces direction d (for MIS)."""
    cos_g = dot(d, jnp.broadcast_to(maps.sun_dir, d.shape))
    in_cone = cos_g > SUN_COS_THETA_MAX
    up = maps.sun_dir[1] > -0.05
    return jnp.where(in_cone & up,
                     uniform_cone_pdf(jnp.float32(SUN_COS_THETA_MAX)), 0.0)


# ---------------------------------------------------------------------------
# sphere lights (reference: RENDER_SPHERE_LIGHT path, src/light.cuh:240-270)
# ---------------------------------------------------------------------------


class SphereLights(NamedTuple):
    center: jnp.ndarray    # (L,3)
    radius: jnp.ndarray    # (L,)
    emission: jnp.ndarray  # (L,3)


def sample_sphere_light(lights: SphereLights, light_idx, p, u2) -> LightSample:
    """Cone-sample one sphere light toward shading point p (...,3)."""
    c = lights.center[light_idx]
    r = lights.radius[light_idx]
    em = lights.emission[light_idx]
    to_c = c - p
    d2 = jnp.maximum(dot(to_c, to_c), 1e-8)
    dist = jnp.sqrt(d2)
    axis = to_c / dist[..., None]
    sin2_max = jnp.clip(r * r / d2, 0.0, 0.9999)
    cos_max = jnp.sqrt(1.0 - sin2_max)
    local = uniform_cone(u2, cos_max)
    t, b = orthonormal_basis(axis)
    wi = normalize(local[..., 0:1] * t + local[..., 1:2] * b
                   + local[..., 2:3] * axis)
    pdf = uniform_cone_pdf(cos_max)
    # hit distance to the sphere surface along wi (approx: to the cone cap)
    hit_dist = dist * local[..., 2] - jnp.sqrt(
        jnp.maximum(r * r - d2 * (1.0 - local[..., 2] ** 2), 0.0))
    return LightSample(wi, em, pdf, jnp.maximum(hit_dist, 0.0))
