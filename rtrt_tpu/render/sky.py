"""Physically-based sky: single-scattering Rayleigh + Mie atmosphere.

Counterpart of the reference's environment lighting: it renders sky radiance
into a 512x256 *equal-area* map plus a small sun-cone map with limb
darkening, and builds luminance CDFs for importance sampling
(reference: src/sky.cuh:199-320 map kernels, regenerated only on parameter
change at src/kernel.cu:285-308; the Rayleigh-Mie single-scattering model
matches the reference's raymarched atmosphere in src/sky2.cuh:51-130).

Design choices:
  * the map uses the exact equal-area cylindrical (Lambert) projection —
    every texel subtends the same solid angle, so the sampling PDF is just
    normalized luminance (no sin-theta correction anywhere);
  * the raymarch is a fixed-shape (H*W, VIEW_STEPS) vectorized loop — one
    XLA program, regenerated only when sun/params change;
  * physical constants are the standard published earth-atmosphere values
    (Nishita 1993 lineage).

World convention: +y up; directions are unit vectors in world space.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.color import luminance
from ..core.vecmath import dot, normalize, vec3
from ..ops.scan import pdf_to_cdf

# --- standard earth-atmosphere constants (m) ---
PLANET_RADIUS = 6360e3
ATMOSPHERE_TOP = 6420e3
RAYLEIGH_SCALE_H = 7994.0
MIE_SCALE_H = 1200.0
BETA_RAYLEIGH = jnp.array([5.802e-6, 13.558e-6, 33.1e-6], jnp.float32)
BETA_MIE_SCATTER = 3.996e-6
BETA_MIE_ABSORB = 4.40e-6

SUN_ANGULAR_RADIUS = 0.004675  # radians (~0.268 deg)
SUN_COS_THETA_MAX = float(jnp.cos(SUN_ANGULAR_RADIUS))

SKY_RES = (256, 512)   # (H, W) equal-area map (reference: 512x256)
SUN_RES = (32, 32)     # sun cone map (reference: 32x32)

VIEW_STEPS = 32
LIGHT_STEPS = 8


class SkyParams(NamedTuple):
    """Runtime-tunable sky parameters (analog of the reference's SkyParams
    UI block, src/settingParams.h + sky regeneration flag)."""

    sun_dir: jnp.ndarray        # (3,) unit, +y up
    sun_intensity: jnp.ndarray  # () solar irradiance scale
    rayleigh_scale: jnp.ndarray  # () multiplier on rayleigh scattering
    mie_scale: jnp.ndarray      # () multiplier on mie scattering
    mie_g: jnp.ndarray          # () HG anisotropy
    altitude: jnp.ndarray       # () observer altitude above ground (m)
    ground_albedo: jnp.ndarray  # (3,) below-horizon tint


def make_sky_params(sun_elevation=0.7, sun_azimuth=0.2, sun_intensity=20.0,
                    rayleigh_scale=1.0, mie_scale=1.0, mie_g=0.76,
                    altitude=200.0, ground_albedo=(0.3, 0.25, 0.2)) -> SkyParams:
    ce = jnp.cos(jnp.asarray(sun_elevation, jnp.float32))
    se = jnp.sin(jnp.asarray(sun_elevation, jnp.float32))
    ca = jnp.cos(jnp.asarray(sun_azimuth, jnp.float32))
    sa = jnp.sin(jnp.asarray(sun_azimuth, jnp.float32))
    sun = normalize(vec3(ce * sa, se, ce * ca))
    f = lambda x: jnp.asarray(x, jnp.float32)
    return SkyParams(sun, f(sun_intensity), f(rayleigh_scale), f(mie_scale),
                     f(mie_g), f(altitude), f(jnp.array(ground_albedo)))


def sun_direction_from_time(time_of_day, axis_angle=0.3):
    """Sun direction from a [0,1) day fraction, tilted axis — analog of the
    reference's time-of-day sun path (src/kernel.cu:120-123)."""
    ang = (jnp.asarray(time_of_day, jnp.float32) - 0.25) * 2.0 * jnp.pi
    d = vec3(jnp.cos(ang), jnp.sin(ang), 0.0)
    ca, sa = jnp.cos(axis_angle), jnp.sin(axis_angle)
    # tilt around x: rotate the orbit plane
    return normalize(vec3(d[..., 0], d[..., 1] * ca, d[..., 1] * sa))


# ---------------------------------------------------------------------------
# equal-area map parameterization (exact Lambert cylindrical)
# ---------------------------------------------------------------------------


def dir_to_equal_area_uv(d):
    """Unit dir (...,3) -> uv (...,2) in [0,1); equal-area in solid angle."""
    u = jnp.arctan2(d[..., 2], d[..., 0]) / (2.0 * jnp.pi) + 0.5
    v = (d[..., 1] + 1.0) * 0.5  # y uniform == equal-area
    return jnp.stack([u, v], axis=-1)


def equal_area_uv_to_dir(uv):
    """Inverse of dir_to_equal_area_uv."""
    phi = (uv[..., 0] - 0.5) * 2.0 * jnp.pi
    y = uv[..., 1] * 2.0 - 1.0
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - y * y))
    return vec3(r * jnp.cos(phi), y, r * jnp.sin(phi))


def texel_solid_angle(h, w):
    return 4.0 * jnp.pi / (h * w)


# ---------------------------------------------------------------------------
# single-scattering raymarch
# ---------------------------------------------------------------------------


def _atmosphere_intersect(org, d, radius):
    """Far intersection distance of ray with sphere |p|=radius (0 if none)."""
    b = dot(org, d)
    c = dot(org, org) - radius * radius
    disc = b * b - c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t = -b + sq
    return jnp.where(disc > 0.0, jnp.maximum(t, 0.0), 0.0)


def _densities(p):
    """(rayleigh, mie) relative densities at points p (...,3)."""
    h = jnp.sqrt(jnp.maximum(dot(p, p), 1.0)) - PLANET_RADIUS
    h = jnp.maximum(h, 0.0)
    return jnp.exp(-h / RAYLEIGH_SCALE_H), jnp.exp(-h / MIE_SCALE_H)


def _optical_depth_to_sun(p, sun_dir):
    """Rayleigh/Mie optical depth from p to the top of the atmosphere."""
    t_top = _atmosphere_intersect(p, jnp.broadcast_to(sun_dir, p.shape), ATMOSPHERE_TOP)
    ds = t_top / LIGHT_STEPS
    od_r = jnp.zeros(p.shape[:-1], jnp.float32)
    od_m = jnp.zeros(p.shape[:-1], jnp.float32)
    for i in range(LIGHT_STEPS):
        sp = p + sun_dir * ((i + 0.5) * ds)[..., None]
        dr, dm = _densities(sp)
        od_r = od_r + dr * ds
        od_m = od_m + dm * ds
    return od_r, od_m


def _phase_rayleigh(mu):
    return 3.0 / (16.0 * jnp.pi) * (1.0 + mu * mu)


def _phase_hg(mu, g):
    """Henyey-Greenstein (reference: src/sky2.cuh phase functions)."""
    g2 = g * g
    denom = jnp.maximum(1.0 + g2 - 2.0 * g * mu, 1e-6)
    return (1.0 - g2) / (4.0 * jnp.pi * denom * jnp.sqrt(denom))


def atmosphere_radiance(view_dirs, params: SkyParams):
    """Single-scattered sky radiance along view dirs (...,3) -> (...,3).

    Fixed VIEW_STEPS x LIGHT_STEPS march, vectorized over all dirs.
    View rays that hit the planet march only to the ground point (the dark
    band below the horizon; scene geometry normally covers it).
    """
    org = jnp.zeros_like(view_dirs) + vec3(0.0, PLANET_RADIUS + jnp.maximum(params.altitude, 1.0), 0.0)
    d = view_dirs

    t_atmo = _atmosphere_intersect(org, d, ATMOSPHERE_TOP)
    # nearest ground hit bounds the march
    b = dot(org, d)
    c = dot(org, org) - PLANET_RADIUS * PLANET_RADIUS
    disc = b * b - c
    t_ground = jnp.where((disc > 0.0) & (-b - jnp.sqrt(jnp.maximum(disc, 0.0)) > 0.0),
                         -b - jnp.sqrt(jnp.maximum(disc, 0.0)), jnp.inf)
    t_end = jnp.minimum(t_atmo, t_ground)

    beta_r = BETA_RAYLEIGH * params.rayleigh_scale
    beta_ms = BETA_MIE_SCATTER * params.mie_scale
    beta_me = (BETA_MIE_SCATTER + BETA_MIE_ABSORB) * params.mie_scale

    mu = dot(d, jnp.broadcast_to(params.sun_dir, d.shape))
    ph_r = _phase_rayleigh(mu)
    ph_m = _phase_hg(mu, params.mie_g)

    ds = t_end / VIEW_STEPS
    od_r = jnp.zeros(d.shape[:-1], jnp.float32)
    od_m = jnp.zeros(d.shape[:-1], jnp.float32)
    sum_r = jnp.zeros(d.shape, jnp.float32)
    sum_m = jnp.zeros(d.shape, jnp.float32)
    for i in range(VIEW_STEPS):
        p = org + d * ((i + 0.5) * ds)[..., None]
        dr, dm = _densities(p)
        od_r = od_r + dr * ds
        od_m = od_m + dm * ds
        sod_r, sod_m = _optical_depth_to_sun(p, params.sun_dir)
        tau = (beta_r * (od_r + sod_r)[..., None]
               + beta_me * (od_m + sod_m)[..., None])
        attn = jnp.exp(-tau)
        sum_r = sum_r + attn * (dr * ds)[..., None]
        sum_m = sum_m + attn * (dm * ds)[..., None]

    radiance = params.sun_intensity * (
        sum_r * beta_r * ph_r[..., None] + sum_m * beta_ms * ph_m[..., None])

    # below-horizon: fade to a simple ground tint lit by the sky (the scene's
    # own geometry normally covers this; analog of the reference's horizon
    # mist blend, src/light.cuh:50-54)
    hit_ground = jnp.isfinite(t_ground)
    sun_up = jnp.maximum(params.sun_dir[1], 0.0)
    ground = params.ground_albedo * (0.3 + 0.7 * sun_up) * params.sun_intensity * 0.01
    radiance = jnp.where(hit_ground[..., None], radiance + ground, radiance)
    return radiance


PREETHAM_TURBIDITY = 2.5
# Radiometric calibration: the Preetham model returns Y in kcd/m^2; the
# engine's physical model returns radiance in its own sun_intensity-scaled
# units.  The constant maps the Preetham scale onto the physical scale so
# exposure, sun-disk balance and env CDF weights stay comparable:
# mean hemisphere luminance, physical model @ elev 0.7 / I=20  = 0.3376
# mean hemisphere luminance, Preetham T=2.5 @ elev 0.7          = 9.107
# (both measured over a 3000-dir Fibonacci hemisphere, tools/sky_compare.py)
PREETHAM_LUM_SCALE = 0.3376 / 9.107


def preetham_radiance(view_dirs, params: SkyParams,
                      turbidity: float = PREETHAM_TURBIDITY):
    """Fitted analytic daylight sky (Preetham et al. 1999) along (...,3)
    view dirs -> (...,3) linear-sRGB radiance.

    This is the framework's ACTIVE fitted-sky option — the same model
    family as the reference's Hosek-Wilkie sky (reference: src/sky.cuh:
    91-320; Hosek-Wilkie 2012 is the direct successor fit of this model),
    implemented from the published Perez/Preetham formulas rather than the
    reference's shipped coefficient dataset (src/skyData.h).  The numpy
    twin in render/skyref.py carries the constants; tests pin this jnp
    version against it (tests/test_sky_parity.py).

    Selected via bake_sky_maps(model="preetham") / GlobalSettings.sky_model.
    """
    from .skyref import (_PEREZ_X, _PEREZ_Y, _ZENITH_X, _ZENITH_Y,
                         perez_coeffs_chroma, preetham_coeffs_Y)

    up = jnp.clip(view_dirs[..., 1], 1e-3, 1.0)   # horizon clamp
    cos_t = jnp.maximum(up, 1e-3)
    sun = params.sun_dir
    cos_g = jnp.clip(jnp.sum(view_dirs * sun, axis=-1), -1.0, 1.0)
    gamma = jnp.arccos(cos_g)
    cos_g2 = cos_g * cos_g
    theta_s = jnp.arccos(jnp.clip(sun[1], -1.0, 1.0))
    cos_ts = jnp.clip(sun[1], 1e-3, 1.0)

    t = float(turbidity)

    def perez_f(cos_theta, gam, cg2, a, b, c, d, e):
        return ((1.0 + a * jnp.exp(b / cos_theta))
                * (1.0 + c * jnp.exp(d * gam) + e * cg2))

    def channel(coef, zenith_val):
        f = perez_f(cos_t, gamma, cos_g2, *coef)
        f0 = perez_f(1.0, theta_s, cos_ts * cos_ts, *coef)
        return zenith_val * f / jnp.maximum(f0, 1e-9)

    # zenith values (polynomials of turbidity x sun zenith; skyref tables)
    chi = (4.0 / 9.0 - t / 120.0) * (jnp.pi - 2.0 * theta_s)
    yz = jnp.maximum((4.0453 * t - 4.9710) * jnp.tan(chi)
                     - 0.2155 * t + 2.4192, 1e-3)
    tv = jnp.array([t * t, t, 1.0], jnp.float32)

    def zen_chroma(m):
        th = jnp.stack([theta_s ** 3, theta_s ** 2, theta_s,
                        jnp.ones_like(theta_s)])
        hi = jax.lax.Precision.HIGHEST   # full float32, not TF32
        return jnp.dot(jnp.dot(tv, jnp.asarray(m, jnp.float32), precision=hi),
                       th, precision=hi)

    yy = channel(preetham_coeffs_Y(t), yz)
    x = channel(perez_coeffs_chroma(t, _PEREZ_X), zen_chroma(_ZENITH_X))
    y = channel(perez_coeffs_chroma(t, _PEREZ_Y), zen_chroma(_ZENITH_Y))

    y_safe = jnp.maximum(y, 1e-6)
    # PREETHAM_LUM_SCALE calibrates at I=20; physical radiance scales
    # linearly with sun_intensity
    yy = jnp.maximum(yy, 0.0) \
        * PREETHAM_LUM_SCALE * (params.sun_intensity / 20.0)
    big_x = x / y_safe * yy
    big_z = (1.0 - x - y) / y_safe * yy
    xyz = jnp.stack([big_x, yy, big_z], axis=-1)
    m = jnp.array([[3.2406, -1.5372, -0.4986],
                   [-0.9689, 1.8758, 0.0415],
                   [0.0557, -0.2040, 1.0570]], jnp.float32)
    rgb = jnp.maximum(jnp.dot(xyz, m.T, precision=jax.lax.Precision.HIGHEST),
                      0.0)

    # below-horizon ground tint (same blend as the physical model)
    sun_up = jnp.maximum(sun[1], 0.0)
    ground = params.ground_albedo * (0.3 + 0.7 * sun_up) \
        * params.sun_intensity * 0.01
    return jnp.where((view_dirs[..., 1] <= 0.0)[..., None],
                     rgb + ground, rgb)


def transmittance_to_sun(params: SkyParams):
    """Transmittance from the observer toward the sun (for direct sun disk)."""
    org = vec3(0.0, PLANET_RADIUS + jnp.maximum(params.altitude, 1.0), 0.0)
    od_r, od_m = _optical_depth_to_sun(org[None, :], params.sun_dir)
    beta_r = BETA_RAYLEIGH * params.rayleigh_scale
    beta_me = (BETA_MIE_SCATTER + BETA_MIE_ABSORB) * params.mie_scale
    tau = beta_r * od_r[0] + beta_me * od_m[0]
    return jnp.exp(-tau)


# ---------------------------------------------------------------------------
# map baking + CDFs
# ---------------------------------------------------------------------------


class SkyMaps(NamedTuple):
    """Baked environment state, regenerated only on parameter change.

    Includes O(1) Walker alias tables for importance sampling (replacing
    binary-searched CDF inversion — searchsorted costs 17 gathers; the
    alias method costs 2) and per-texel solid-angle
    PDFs for MIS.  Alias tables are built host-side by
    `finalize_sky_maps` after the jitted bake."""

    sky_map: jnp.ndarray   # (H, W, 3) radiance
    sky_cdf: jnp.ndarray   # (H*W,) inclusive luminance CDF
    sky_flux: jnp.ndarray  # () total luminous flux of the sky map
    sun_map: jnp.ndarray   # (Sh, Sw, 3) radiance across the sun cone
    sun_cdf: jnp.ndarray   # (Sh*Sw,)
    sun_flux: jnp.ndarray  # ()
    sun_dir: jnp.ndarray   # (3,)
    sun_basis_t: jnp.ndarray  # (3,) tangent of the sun frame
    sun_basis_b: jnp.ndarray
    params: SkyParams         # the generating parameters (for analytic eval)
    sun_trans: jnp.ndarray    # (3,) transmittance toward the sun
    sky_pdf: jnp.ndarray      # (H*W,) solid-angle pdf per texel
    sun_pdf: jnp.ndarray      # (Sh*Sw,)
    sky_alias_p: jnp.ndarray  # (H*W,) alias acceptance probability
    sky_alias_j: jnp.ndarray  # (H*W,) i32 alias partner
    sun_alias_p: jnp.ndarray
    sun_alias_j: jnp.ndarray
    env_fit: jnp.ndarray = None  # (ENV_FIT_DEG^2, 3) Chebyshev tensor fit of
    #   the sky map in (sin-elevation, cos-azimuth-to-sun) — the gather-free
    #   per-ray environment eval (see env_radiance_fit)


def bake_sky_maps(params: SkyParams, sky_res=SKY_RES, sun_res=SUN_RES,
                  model: str = "physical") -> SkyMaps:
    """model: "physical" (Rayleigh-Mie single scattering, the default) or
    "preetham" (fitted analytic daylight — the reference's active-sky
    model family, src/sky.cuh:91-320).  Static arg: part of the jit key.
    Everything downstream (CDFs, alias tables, Chebyshev env fit, MIS
    pdfs) derives from the baked map, so the whole engine follows the
    selected model with no other changes."""
    h, w = sky_res
    vv, uu = jnp.meshgrid(
        (jnp.arange(h, dtype=jnp.float32) + 0.5) / h,
        (jnp.arange(w, dtype=jnp.float32) + 0.5) / w, indexing="ij")
    dirs = equal_area_uv_to_dir(jnp.stack([uu, vv], axis=-1))
    radiance_fn = {"physical": atmosphere_radiance,
                   "preetham": preetham_radiance}[model]
    sky = radiance_fn(dirs, params)
    omega = texel_solid_angle(h, w)
    sky_lum = luminance(sky) * omega
    sky_cdf, sky_flux = pdf_to_cdf(sky_lum.reshape(-1))

    # --- sun cone map (limb-darkened disk radiance x transmittance) ---
    sh, sw = sun_res
    from ..core.vecmath import orthonormal_basis
    t, bvec = orthonormal_basis(params.sun_dir)
    sy, sx = jnp.meshgrid(
        (jnp.arange(sh, dtype=jnp.float32) + 0.5) / sh * 2.0 - 1.0,
        (jnp.arange(sw, dtype=jnp.float32) + 0.5) / sw * 2.0 - 1.0, indexing="ij")
    r2 = sx * sx + sy * sy
    in_disk = r2 <= 1.0
    # limb darkening I(mu)/I0 = 1 - u(1 - mu), u = 0.6 (standard photometric fit)
    mu = jnp.sqrt(jnp.maximum(1.0 - r2, 0.0))
    limb = jnp.where(in_disk, 1.0 - 0.6 * (1.0 - mu), 0.0)
    trans = transmittance_to_sun(params)
    # normalize so the disk integrates to sun_intensity-scaled irradiance:
    # radiance = E_sun / solid_angle_of_disk
    disk_omega = 2.0 * jnp.pi * (1.0 - SUN_COS_THETA_MAX)
    sun_rad = (params.sun_intensity / disk_omega) * limb[..., None] * trans
    # per-texel solid angle: the disk's solid angle spread over its texels
    sun_texel_omega = disk_omega / jnp.maximum(jnp.sum(in_disk), 1)
    sun_lum = luminance(sun_rad) * jnp.where(in_disk, sun_texel_omega, 0.0)
    sun_cdf, sun_flux = pdf_to_cdf(sun_lum.reshape(-1))

    # per-texel solid-angle pdfs (probability / texel solid angle)
    sky_w = sky_lum.reshape(-1)
    sky_pdf = sky_w / jnp.maximum(jnp.sum(sky_w), 1e-20) / omega
    sun_w = sun_lum.reshape(-1)
    sun_pdf = sun_w / jnp.maximum(jnp.sum(sun_w), 1e-20) / sun_texel_omega

    # env_fit is solved host-side in float64 (finalize_sky_maps): the
    # degree-14 normal equations are too ill-conditioned for an f32 LU
    env_fit = jnp.zeros((2, ENV_FIT_DEG * ENV_FIT_DEG, 3), jnp.float32)

    zf = lambda k: jnp.zeros((k,), jnp.float32)
    zi = lambda k: jnp.zeros((k,), jnp.int32)
    return SkyMaps(sky, sky_cdf, sky_flux, sun_rad, sun_cdf, sun_flux,
                   params.sun_dir, t, bvec, params, trans,
                   sky_pdf, sun_pdf,
                   zf(h * w), zi(h * w), zf(sh * sw), zi(sh * sw),
                   env_fit)


# ---------------------------------------------------------------------------
# gather-free environment eval: Chebyshev tensor fit of the baked sky
# ---------------------------------------------------------------------------
#
# Escaped rays need sky radiance per pixel.  The analytic raymarch costs
# VIEW_STEPS x LIGHT_STEPS = 256 density/transmittance steps per ray, and a
# map lookup is a per-lane gather.  But a clear-atmosphere sky with the sun
# disk handled separately is SMOOTH and depends only on (sin elevation,
# cos azimuth-to-sun), so a small tensor-Chebyshev fit of the already-baked
# map evaluates in ~200 dense flops per ray.  The fit
# is re-solved at bake time (normal equations on the equal-area grid =
# uniform solid-angle weighting; one (B,B) solve, B = ENV_FIT_DEG^2).

ENV_FIT_DEG = 14   # Chebyshev degree per axis (B = 196 coeffs/hemisphere)
ENV_FIT_RCOND = 1e-5  # lstsq singular-value cutoff (see _fit_env_host)


def _cheb_list(x, deg):
    ts = [jnp.ones_like(x), x]
    for _ in range(deg - 2):
        ts.append(2.0 * x * ts[-1] - ts[-2])
    return ts[:deg]


def _env_coords(d, sun_dir):
    """Fit coordinates of dirs (...,3):
      xs: sqrt-stretched |elevation| in [-1,1] (resolution concentrated at
          the horizon, where path length and gradients blow up),
      c:  cos azimuth-to-sun in [-1,1],
      s:  sin elevation (hemisphere blend weight in env_radiance_fit)."""
    s = jnp.clip(d[..., 1], -1.0, 1.0)
    xs = 2.0 * jnp.sqrt(jnp.abs(s)) - 1.0
    hx, hz = d[..., 0], d[..., 2]
    hn = jnp.sqrt(hx * hx + hz * hz)
    sx, sz = sun_dir[0], sun_dir[2]
    sn = jnp.sqrt(sx * sx + sz * sz)
    denom = jnp.maximum(hn * sn, 1e-8)
    c = jnp.clip((hx * sx + hz * sz) / denom, -1.0, 1.0)
    # near the zenith/nadir (or sun at zenith) azimuth is undefined — the
    # true radiance is azimuth-independent there, pick c = 0
    c = jnp.where((hn < 1e-6) | (sn < 1e-6), 0.0, c)
    return xs, c, s


def _fit_env_host(sky_map, sun_dir):
    """Luminance-weighted least-squares Chebyshev fit of the baked
    equal-area sky map, one coefficient set per hemisphere (the horizon is
    a hard discontinuity — fitting across it rings).

    Runs HOST-SIDE in numpy float64 (called from finalize_sky_maps): the
    degree-14 normal equations are ill-conditioned, and solving them in
    device f32 visibly shifts the fitted sky and breaks agreement between
    backends.  f64 on host makes the coefficients bit-identical on every
    backend.
    sky_map: (H,W,3); sun_dir: (3,) -> (2, B, 3) f32 coefficients."""
    import numpy as np
    h, w = sky_map.shape[:2]
    sky = np.asarray(sky_map, np.float64)
    sd = np.asarray(sun_dir, np.float64)
    # equal-area texel dirs (numpy twin of equal_area_uv_to_dir)
    u = (np.arange(w, dtype=np.float64) + 0.5) / w
    v = (np.arange(h, dtype=np.float64) + 0.5) / h
    vv, uu = np.meshgrid(v, u, indexing="ij")
    phi_a = (uu - 0.5) * 2.0 * np.pi
    y_e = vv * 2.0 - 1.0
    r = np.sqrt(np.maximum(0.0, 1.0 - y_e * y_e))
    dx, dy, dz = r * np.cos(phi_a), y_e, r * np.sin(phi_a)

    # fit coords (numpy twin of _env_coords)
    s = np.clip(dy, -1.0, 1.0)
    xs = 2.0 * np.sqrt(np.abs(s)) - 1.0
    hn = np.sqrt(dx * dx + dz * dz)
    sn = np.sqrt(sd[0] ** 2 + sd[2] ** 2)
    c = np.clip((dx * sd[0] + dz * sd[2]) / np.maximum(hn * sn, 1e-8),
                -1.0, 1.0)
    c = np.where((hn < 1e-6) | (sn < 1e-6), 0.0, c)
    up = s >= 0.0

    def cheb(x, deg):
        ts = [np.ones_like(x), x]
        for _ in range(deg - 2):
            ts.append(2.0 * x * ts[-1] - ts[-2])
        return ts[:deg]

    b = ENV_FIT_DEG * ENV_FIT_DEG
    ts = cheb(xs, ENV_FIT_DEG)
    tc = cheb(c, ENV_FIT_DEG)
    phi = np.stack([a * t for a in ts for t in tc], axis=-1).reshape(-1, b)
    yv = sky.reshape(-1, 3)
    # weight ~ 1/luminance: optimize RELATIVE error (the dim zenith counts
    # as much as the bright horizon)
    lum = np.maximum(yv.mean(axis=-1), 1e-6)
    wgt = 1.0 / (lum + 0.05 * lum.mean())
    upf = up.reshape(-1)

    def solve(mask):
        # SVD lstsq with an aggressive rcond cutoff, NOT normal equations:
        # the degree-196 basis is ill-conditioned enough that a raw solve
        # amplifies ~1e-5 input noise (f32 backend differences in the baked
        # map) into O(1) coefficient swings between backends.
        # Truncating the near-null directions makes the coefficients stable
        # under input noise at negligible accuracy cost.
        sw = np.sqrt(wgt * mask)[:, None]
        coef, _, _, _ = np.linalg.lstsq(phi * sw, yv * sw,
                                        rcond=ENV_FIT_RCOND)
        return coef

    out = np.stack([solve(upf.astype(np.float64)),
                    solve((~upf).astype(np.float64))])
    return out.astype(np.float32)


# The two hemisphere fits meet at the horizon with a step; a hard `s >= 0`
# select there is numerically fragile (escaped bounce directions differ by
# ~1e-6 between backends after f32 shading math, so seam pixels would flip
# hemispheres and jump by the full step).  Blend over a band of width
# s_min = 1/H (the innermost training row's |sin elevation|) instead, and
# CLAMP each hemisphere's sqrt-stretch coordinate to that same s_min: the
# band |s| < s_min holds no training samples, and evaluating the fit there
# means extrapolating at the Chebyshev edge x = -1, where the series rings
# worst (measured: 3.4x the true radiance at s = 0 exactly — a speckled
# bright band at the rendered horizon).  Clamping pins the band to the two
# edge-row values; the blend interpolates between them.


def env_radiance_fit(maps: SkyMaps, d):
    """Escaped-ray radiance: Chebyshev sky fit + analytic sun disk — dense
    arithmetic, no gathers, no raymarch (the production escape-path eval;
    env_radiance_analytic is the exact oracle it is tested against)."""
    _, c, s = _env_coords(d, maps.sun_dir)
    s_min = 1.0 / maps.sky_map.shape[0]  # static shape -> python float
    xs_up = 2.0 * jnp.sqrt(jnp.clip(s, s_min, 1.0)) - 1.0
    xs_dn = 2.0 * jnp.sqrt(jnp.clip(-s, s_min, 1.0)) - 1.0
    ts_up = _cheb_list(xs_up, ENV_FIT_DEG)
    ts_dn = _cheb_list(xs_dn, ENV_FIT_DEG)
    tc = _cheb_list(c, ENV_FIT_DEG)
    up = jnp.zeros(d.shape[:-1] + (3,), jnp.float32)
    dn = jnp.zeros(d.shape[:-1] + (3,), jnp.float32)
    k = 0
    for i in range(ENV_FIT_DEG):
        for j in range(ENV_FIT_DEG):
            up = up + (ts_up[i] * tc[j])[..., None] * maps.env_fit[0, k]
            dn = dn + (ts_dn[i] * tc[j])[..., None] * maps.env_fit[1, k]
            k += 1
    t = jnp.clip((s / s_min + 1.0) * 0.5, 0.0, 1.0)
    w = (t * t * (3.0 - 2.0 * t))[..., None]  # smoothstep across the seam
    out = w * up + (1.0 - w) * dn
    return jnp.maximum(out, 0.0) + sun_disk_radiance(maps, d)


def build_alias_table(weights):
    """Walker/Vose alias method (host-side numpy, O(n)).

    Returns (prob (n,) f32, alias (n,) i32): sample k=floor(u1*n); take k if
    u2 < prob[k] else alias[k].  Zero-total weights yield uniform."""
    import numpy as np
    w = np.asarray(weights, np.float64).copy()
    n = w.size
    total = w.sum()
    if total <= 0:
        return (np.ones(n, np.float32), np.arange(n, dtype=np.int32))
    p = w * (n / total)
    prob = np.ones(n, np.float32)
    alias = np.arange(n, dtype=np.int32)
    small = [i for i in range(n) if p[i] < 1.0]
    large = [i for i in range(n) if p[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = p[s]
        alias[s] = l
        p[l] = (p[l] + p[s]) - 1.0
        (small if p[l] < 1.0 else large).append(l)
    for i in large + small:
        prob[i] = 1.0
    return prob, alias


def finalize_sky_maps(maps: SkyMaps) -> SkyMaps:
    """Attach host-built alias tables (call after the jitted bake)."""
    import numpy as np
    h, w = maps.sky_map.shape[0], maps.sky_map.shape[1]
    sky_w = np.maximum(np.asarray(maps.sky_pdf), 0.0)
    sun_w = np.maximum(np.asarray(maps.sun_pdf), 0.0)
    sp, sj = build_alias_table(sky_w)
    up, uj = build_alias_table(sun_w)
    env_fit = _fit_env_host(maps.sky_map, maps.sun_dir)
    return maps._replace(sky_alias_p=jnp.asarray(sp),
                         sky_alias_j=jnp.asarray(sj),
                         sun_alias_p=jnp.asarray(up),
                         sun_alias_j=jnp.asarray(uj),
                         env_fit=jnp.asarray(env_fit))


def sun_disk_radiance(maps: SkyMaps, d):
    """Analytic limb-darkened sun disk radiance along dirs (...,3)."""
    cos_g = dot(d, jnp.broadcast_to(maps.sun_dir, d.shape))
    in_cone = cos_g > SUN_COS_THETA_MAX
    sin2 = jnp.maximum(1.0 - cos_g * cos_g, 0.0)
    sin2_max = 1.0 - SUN_COS_THETA_MAX * SUN_COS_THETA_MAX
    mu = jnp.sqrt(jnp.maximum(1.0 - sin2 / sin2_max, 0.0))
    limb = 1.0 - 0.6 * (1.0 - mu)
    disk_omega = 2.0 * jnp.pi * (1.0 - SUN_COS_THETA_MAX)
    rad = (maps.params.sun_intensity / disk_omega) * limb[..., None] \
        * maps.sun_trans
    return jnp.where(in_cone[..., None], rad, 0.0)


def env_radiance_analytic(maps: SkyMaps, d):
    """Escaped-ray radiance evaluated analytically (raymarch + sun disk) —
    pure arithmetic, no map gathers.  Matches the baked maps by construction
    (same atmosphere model)."""
    return atmosphere_radiance(d, maps.params) + sun_disk_radiance(maps, d)


# ---------------------------------------------------------------------------
# lookups
# ---------------------------------------------------------------------------


def _bilinear_wrap_u(img, uv):
    """Bilinear sample with wrap in u, clamp in v.  img (H,W,C), uv (...,2)."""
    h, w = img.shape[0], img.shape[1]
    x = uv[..., 0] * w - 0.5
    y = jnp.clip(uv[..., 1] * h - 0.5, 0.0, h - 1.0)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    x1i = jnp.mod(x0i + 1, w)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    y1i = jnp.clip(y0i + 1, 0, h - 1)
    c00 = img[y0i, x0i]
    c01 = img[y0i, x1i]
    c10 = img[y1i, x0i]
    c11 = img[y1i, x1i]
    fx = fx[..., None]
    fy = fy[..., None]
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy


def sky_radiance(maps: SkyMaps, d):
    """Environment radiance for escaped rays: sky map + sun disk
    (analog of GetLightSource / EnvLight2, reference: src/light.cuh:275-305)."""
    sky = _bilinear_wrap_u(maps.sky_map, dir_to_equal_area_uv(d))
    # sun disk: project dir into the sun frame
    cos_g = dot(d, jnp.broadcast_to(maps.sun_dir, d.shape))
    in_cone = cos_g > SUN_COS_THETA_MAX
    tx = dot(d, jnp.broadcast_to(maps.sun_basis_t, d.shape))
    ty = dot(d, jnp.broadcast_to(maps.sun_basis_b, d.shape))
    scale = 1.0 / jnp.float32(jnp.sin(SUN_ANGULAR_RADIUS))
    su = (tx * scale + 1.0) * 0.5
    sv = (ty * scale + 1.0) * 0.5
    inside_uv = (su >= 0) & (su < 1) & (sv >= 0) & (sv < 1)
    sun_uv = jnp.stack([jnp.clip(su, 0.0, 1.0), jnp.clip(sv, 0.0, 1.0)], axis=-1)
    sun = _bilinear_clamp(maps.sun_map, sun_uv)
    return sky + jnp.where((in_cone & inside_uv)[..., None], sun, 0.0)


def _bilinear_clamp(img, uv):
    h, w = img.shape[0], img.shape[1]
    x = jnp.clip(uv[..., 0] * w - 0.5, 0.0, w - 1.0)
    y = jnp.clip(uv[..., 1] * h - 0.5, 0.0, h - 1.0)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    x1i = jnp.clip(x0i + 1, 0, w - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    y1i = jnp.clip(y0i + 1, 0, h - 1)
    c00 = img[y0i, x0i]
    c01 = img[y0i, x1i]
    c10 = img[y1i, x0i]
    c11 = img[y1i, x1i]
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy
