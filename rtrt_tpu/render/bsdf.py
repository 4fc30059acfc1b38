"""BSDF models: Lambertian, perfect mirror, Fresnel glass, GGX microfacet.

Counterpart of the reference's BSDF library
(reference: src/bsdf.cuh:69-331, mirror at src/surfaceInteraction.cuh:18-23).
All models are evaluated *branchlessly over material type* — every lane
computes every lobe and selects by material id, which is the vectorization-
friendly translation of the reference's per-thread switch.

Conventions:
  * wo = direction toward the viewer (away from surface), wi = sampled
    direction (away from surface); n = shading normal oriented to wo's side.
  * sample_bsdf returns weight = f * cos / pdf directly (delta lobes fold the
    Dirac through, matching the reference's throughput update).
  * Glass is the reference's perfect (delta) Fresnel reflect/refract with TIR.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

import jax

from ..core.vecmath import (dot, dotk, local_to_world, normalize,
                            orthonormal_basis, reflect, refract, vec3)
from .sampling import cosine_hemisphere

INV_PI = 0.3183098861837907

# material type ids
MAT_LAMBERT = 0
MAT_MIRROR = 1
MAT_GLASS = 2
MAT_GGX = 3
MAT_EMISSIVE = 4


class Materials(NamedTuple):
    """SoA material table (static length; reference: src/kernel.cuh materials
    setup at src/init.cu:214-269)."""

    mtype: jnp.ndarray      # (M,) int32
    albedo: jnp.ndarray     # (M,3) diffuse / tint
    emission: jnp.ndarray   # (M,3)
    roughness: jnp.ndarray  # (M,)
    ior: jnp.ndarray        # (M,) refraction index (glass)
    f0: jnp.ndarray         # (M,3) specular reflectance at normal incidence
    textured: jnp.ndarray   # (M,) int32: 1 = triplanar material texture


def material_lookup(m: Materials, mat):
    """Branchless material-table lookup via a static where-chain.

    The table is tiny (a handful of entries), so selecting with M compares
    per field needs no per-lane gather.
    Returns (mtype, albedo, roughness, ior, f0, emission, textured).
    """
    n = int(m.mtype.shape[0])
    mtype = jnp.zeros_like(mat)
    albedo = jnp.zeros(mat.shape + (3,), jnp.float32)
    rough = jnp.zeros(mat.shape, jnp.float32)
    ior = jnp.ones(mat.shape, jnp.float32)
    f0 = jnp.zeros(mat.shape + (3,), jnp.float32)
    emission = jnp.zeros(mat.shape + (3,), jnp.float32)
    textured = jnp.zeros(mat.shape, bool)
    for i in range(n):
        sel = mat == i
        sel3 = sel[..., None]
        mtype = jnp.where(sel, m.mtype[i], mtype)
        albedo = jnp.where(sel3, m.albedo[i], albedo)
        rough = jnp.where(sel, m.roughness[i], rough)
        ior = jnp.where(sel, m.ior[i], ior)
        f0 = jnp.where(sel3, m.f0[i], f0)
        emission = jnp.where(sel3, m.emission[i], emission)
        textured = jnp.where(sel, m.textured[i] != 0, textured)
    return mtype, albedo, rough, ior, f0, emission, textured


def make_materials(entries) -> Materials:
    """entries: list of dicts with keys matching Materials fields."""
    import numpy as np
    m = len(entries)
    d = dict(
        mtype=np.zeros(m, np.int32), albedo=np.ones((m, 3), np.float32),
        emission=np.zeros((m, 3), np.float32),
        roughness=np.full(m, 0.5, np.float32),
        ior=np.full(m, 1.5, np.float32),
        f0=np.full((m, 3), 0.04, np.float32), textured=np.zeros(m, np.int32))
    for i, e in enumerate(entries):
        for k, v in e.items():
            d[k][i] = v
    return Materials(**{k: jnp.asarray(v) for k, v in d.items()})


# ---------------------------------------------------------------------------
# Fresnel
# ---------------------------------------------------------------------------


def fresnel_schlick(cos_theta, f0):
    """Schlick approximation (reference: src/bsdf.cuh:123-129); f0 (...,3)."""
    m = jnp.clip(1.0 - cos_theta, 0.0, 1.0)
    return f0 + (1.0 - f0) * (m * m * m * m * m)[..., None] if f0.ndim == cos_theta.ndim + 1 \
        else f0 + (1.0 - f0) * m ** 5


def fresnel_dielectric(cos_i, eta):
    """Exact unpolarized dielectric Fresnel reflectance.

    cos_i: |cos| of incident angle (>=0); eta = n_t / n_i (relative).
    Returns reflectance in [0,1]; 1 on total internal reflection.
    """
    cos_i = jnp.clip(cos_i, 0.0, 1.0)
    sin2_t = (1.0 - cos_i * cos_i) / jnp.maximum(eta * eta, 1e-8)
    tir = sin2_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_t))
    r_par = (eta * cos_i - cos_t) / jnp.maximum(eta * cos_i + cos_t, 1e-8)
    r_perp = (cos_i - eta * cos_t) / jnp.maximum(cos_i + eta * cos_t, 1e-8)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return jnp.where(tir, 1.0, jnp.clip(f, 0.0, 1.0))


# ---------------------------------------------------------------------------
# GGX microfacet (Trowbridge-Reitz) — reference: src/bsdf.cuh:168-298
# ---------------------------------------------------------------------------


def ggx_d(n_dot_h, alpha):
    a2 = alpha * alpha
    d = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / jnp.maximum(jnp.pi * d * d, 1e-8)


def smith_g1(n_dot_v, alpha):
    a2 = alpha * alpha
    denom = n_dot_v + jnp.sqrt(jnp.maximum(a2 + (1.0 - a2) * n_dot_v * n_dot_v, 0.0))
    return 2.0 * n_dot_v / jnp.maximum(denom, 1e-8)


def smith_g2(n_dot_v, n_dot_l, alpha):
    return smith_g1(n_dot_v, alpha) * smith_g1(n_dot_l, alpha)


def ggx_sample_h(n, wo, u, alpha):
    """Sample a VISIBLE half vector (Heitz 2018 VNDF sampling): importance-
    samples D_v(h) = G1(wo) max(0, wo·h) D(h) / (n·wo).  Never produces a
    below-horizon wi for the reflected lobe, and the sample weight
    collapses to F·G2/G1 ∈ [0,1] — markedly lower 1-spp variance than
    plain NDF sampling.  (The reference samples the plain NDF with
    re-sample-on-below-horizon retries, src/bsdf.cuh:168-257; VNDF is the
    strictly better published estimator for the same lobe.)"""
    t, b = orthonormal_basis(n)
    vx = dot(wo, t)
    vy = dot(wo, b)
    vz = jnp.maximum(dot(wo, n), 1e-6)
    # stretch the view by alpha (maps GGX to the uniform hemisphere)
    vhx, vhy, vhz = alpha * vx, alpha * vy, vz
    inv_len = jax.lax.rsqrt(jnp.maximum(vhx * vhx + vhy * vhy + vhz * vhz,
                                        1e-20))
    vhx, vhy, vhz = vhx * inv_len, vhy * inv_len, vhz * inv_len
    # orthonormal frame around the stretched view
    lensq = vhx * vhx + vhy * vhy
    invl = jax.lax.rsqrt(jnp.maximum(lensq, 1e-20))
    ok = lensq > 1e-12
    t1x = jnp.where(ok, -vhy * invl, 1.0)
    t1y = jnp.where(ok, vhx * invl, 0.0)
    # T2 = vh × T1
    t2x = vhy * 0.0 - vhz * t1y
    t2y = vhz * t1x - vhx * 0.0
    t2z = vhx * t1y - vhy * t1x
    # polar sample, lower half projected onto the tilted disk
    r = jnp.sqrt(u[..., 0])
    phi = 2.0 * jnp.pi * u[..., 1]
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vhz)
    p2 = (1.0 - s) * jnp.sqrt(jnp.maximum(0.0, 1.0 - p1 * p1)) + s * p2
    p3 = jnp.sqrt(jnp.maximum(0.0, 1.0 - p1 * p1 - p2 * p2))
    nhx = p1 * t1x + p2 * t2x + p3 * vhx
    nhy = p1 * t1y + p2 * t2y + p3 * vhy
    nhz = p2 * t2z + p3 * vhz
    # unstretch
    hx, hy, hz = alpha * nhx, alpha * nhy, jnp.maximum(nhz, 1e-6)
    inv_h = jax.lax.rsqrt(jnp.maximum(hx * hx + hy * hy + hz * hz, 1e-20))
    hx, hy, hz = hx * inv_h, hy * inv_h, hz * inv_h
    return t * hx[..., None] + b * hy[..., None] + n * hz[..., None]


def ggx_eval(n, wo, wi, albedo, f0, alpha):
    """Evaluate GGX reflection f and the VNDF sampling pdf of wi.

    Returns (f (...,3), pdf (...,)).  pdf = G1(wo)·D / (4 n·wo) — the
    solid-angle density of ggx_sample_h's reflected lobe; eval and sample
    MUST agree for MIS."""
    h = normalize(wo + wi)
    n_dot_v = jnp.maximum(dot(n, wo), 0.0)
    n_dot_l = jnp.maximum(dot(n, wi), 0.0)
    n_dot_h = jnp.maximum(dot(n, h), 0.0)
    v_dot_h = jnp.maximum(dot(wo, h), 0.0)
    d = ggx_d(n_dot_h, alpha)
    g = smith_g2(n_dot_v, n_dot_l, alpha)
    f_spec = fresnel_schlick(v_dot_h, f0)
    denom = jnp.maximum(4.0 * n_dot_v * n_dot_l, 1e-6)
    f = f_spec * (d * g / denom)[..., None] * albedo
    pdf = smith_g1(n_dot_v, alpha) * d / jnp.maximum(4.0 * n_dot_v, 1e-6)
    valid = (n_dot_l > 0.0) & (n_dot_v > 0.0)
    return jnp.where(valid[..., None], f, 0.0), jnp.where(valid, pdf, 0.0)


# ---------------------------------------------------------------------------
# unified sample / eval
# ---------------------------------------------------------------------------


class BsdfSample(NamedTuple):
    wi: jnp.ndarray        # (...,3)
    weight: jnp.ndarray    # (...,3) f * cos / pdf
    pdf: jnp.ndarray       # (...,)  solid-angle pdf (1 for delta lobes)
    is_delta: jnp.ndarray  # (...,) bool — mirror/glass: exclude from MIS


def sample_bsdf(mtype, albedo, roughness, ior, f0, n, wo, inside, u2) -> BsdfSample:
    """Branchless BSDF importance sample over all material types.

    n: shading normal oriented toward wo's hemisphere; `inside` marks rays
    currently inside glass (flips the IOR ratio).
    """
    alpha = jnp.maximum(roughness * roughness, 1e-4)

    # --- Lambert: cosine hemisphere ---
    wi_lam = local_to_world(cosine_hemisphere(u2), n)
    pdf_lam = jnp.maximum(dot(n, wi_lam), 0.0) * INV_PI
    w_lam = albedo  # (cos/pi) * albedo / (cos/pi)

    # --- mirror ---
    wi_mir = reflect(-wo, n)
    w_mir = albedo

    # --- glass: stochastic Fresnel reflect/refract ---
    eta_rel = jnp.where(inside, ior, 1.0 / ior)  # n_i / n_t for refract()
    cos_i = jnp.maximum(dot(wo, n), 0.0)
    fr = fresnel_dielectric(cos_i, 1.0 / jnp.maximum(eta_rel, 1e-6))
    refr_dir, tir = refract(-wo, n, eta_rel)
    choose_refl = (u2[..., 0] < fr) | tir
    wi_gls = jnp.where(choose_refl[..., None], reflect(-wo, n), refr_dir)
    w_gls = albedo  # energy-preserving: weight f/pdf cancels for both events

    # --- GGX ---
    h = ggx_sample_h(n, wo, u2, alpha)
    wi_ggx = reflect(-wo, h)
    f_ggx, pdf_ggx = ggx_eval(n, wo, wi_ggx, albedo, f0, alpha)
    cos_ggx = jnp.maximum(dot(n, wi_ggx), 0.0)
    w_ggx = jnp.where((pdf_ggx > 1e-7)[..., None],
                      f_ggx * (cos_ggx / jnp.maximum(pdf_ggx, 1e-7))[..., None],
                      0.0)

    t = mtype[..., None]
    wi = jnp.where(t == MAT_LAMBERT, wi_lam,
                   jnp.where(t == MAT_MIRROR, wi_mir,
                             jnp.where(t == MAT_GLASS, wi_gls, wi_ggx)))
    weight = jnp.where(t == MAT_LAMBERT, w_lam,
                       jnp.where(t == MAT_MIRROR, w_mir,
                                 jnp.where(t == MAT_GLASS, w_gls, w_ggx)))
    pdf = jnp.where(mtype == MAT_LAMBERT, pdf_lam,
                    jnp.where(mtype == MAT_GGX, pdf_ggx, 1.0))
    is_delta = (mtype == MAT_MIRROR) | (mtype == MAT_GLASS)
    wi = normalize(wi)
    return BsdfSample(wi, weight, pdf, is_delta)


def eval_bsdf(mtype, albedo, roughness, f0, n, wo, wi):
    """Evaluate f and pdf for a GIVEN wi (for light-sample MIS).  Delta lobes
    return zero (cannot be hit by light sampling)."""
    alpha = jnp.maximum(roughness * roughness, 1e-4)
    cos_l = jnp.maximum(dot(n, wi), 0.0)

    f_lam = albedo * INV_PI
    pdf_lam = cos_l * INV_PI

    f_ggx, pdf_ggx = ggx_eval(n, wo, wi, albedo, f0, alpha)

    t = mtype[..., None]
    f = jnp.where(t == MAT_LAMBERT, f_lam,
                  jnp.where(t == MAT_GGX, f_ggx, 0.0))
    pdf = jnp.where(mtype == MAT_LAMBERT, pdf_lam,
                    jnp.where(mtype == MAT_GGX, pdf_ggx, 0.0))
    valid = cos_l > 0.0
    return jnp.where(valid[..., None], f, 0.0), jnp.where(valid, pdf, 0.0)
