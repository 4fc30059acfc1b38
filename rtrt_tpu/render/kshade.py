"""Component-form shading library for a fused path-trace kernel.

A fused kernel keeps every per-ray quantity as separate component arrays
(the twin in render/megakernel.py runs this form under XLA).  This module
re-expresses the integrator's shading math (BSDFs, sampling warps, the
Owen-Sobol RNG, sun NEE, procedural soil texturing) over a lightweight `V3`
component tuple.

Every function here mirrors its stacked-array twin exactly:
  * sampling warps / RNG    -> render/sampling.py
  * BSDF sample/eval        -> render/bsdf.py  (reference: src/bsdf.cuh)
  * sun NEE                 -> render/light.py (reference: src/light.cuh)
  * soil proctex            -> render/proctex.py
  * vector helpers          -> core/vecmath.py

and the equivalence is asserted by tests/test_kshade.py on random inputs.
All math is pure elementwise jnp — it runs as plain XLA (which is how it
is tested) and would run unchanged inside a fused Pallas kernel.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from .bsdf import (MAT_GGX, MAT_GLASS, MAT_LAMBERT, MAT_MIRROR,
                   fresnel_dielectric, ggx_d, smith_g1, smith_g2)
from .sampling import (INV_2POW24, TWO_PI, _sobol_dim0, _sobol_dim1,
                       _to_unit_float, hash_combine, owen_scramble,
                       pixel_seed)

U32 = jnp.uint32
INV_PI = 0.3183098861837907


class V3(NamedTuple):
    """A 3-vector held as separate component arrays (any common shape)."""

    x: Any
    y: Any
    z: Any

    def __add__(self, o):
        return V3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return V3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, s):
        if isinstance(s, V3):
            return V3(self.x * s.x, self.y * s.y, self.z * s.z)
        return V3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


def v3_const(x, y, z):
    return V3(jnp.float32(x), jnp.float32(y), jnp.float32(z))


def vdot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def vcross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y,
              a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def vnormalize(a: V3) -> V3:
    """Safe normalize — bit-exact mirror of core/vecmath.normalize (zero
    vectors map to zero, same op sequence so GGX peaks match the XLA path)."""
    n2 = vdot(a, a)
    inv = jnp.where(n2 > 1e-20,
                    jnp.reciprocal(jnp.sqrt(jnp.maximum(n2, 1e-20))), 0.0)
    return a * inv


def vwhere(m, a: V3, b: V3) -> V3:
    return V3(jnp.where(m, a.x, b.x), jnp.where(m, a.y, b.y),
              jnp.where(m, a.z, b.z))


def bwhere(m, a, b):
    """Select between BOOL arrays with logical ops — Mosaic cannot lower
    vector-i1 select_n (it emits an unsupported i8->i1 truncation)."""
    return (m & a) | (~m & b)


def vlum(a: V3):
    """Rec.709 luminance (matches integrator's lum lambda)."""
    return a.x * 0.2126 + a.y * 0.7152 + a.z * 0.0722


def reflect_c(d: V3, n: V3) -> V3:
    """Mirror of core/vecmath.reflect (d points in)."""
    k = 2.0 * vdot(d, n)
    return d - n * k


def refract_c(d: V3, n: V3, eta):
    """Mirror of core/vecmath.refract; returns (dir V3, tir mask)."""
    cos_i = -vdot(d, n)
    sin2_t = eta * eta * jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    tir = sin2_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_t))
    refr = d * eta + n * (eta * cos_i - cos_t)
    return vwhere(tir, reflect_c(d, n), refr), tir


def orthonormal_basis_c(n: V3):
    """Frisvad/Duff branchless ONB (mirror of core/vecmath)."""
    s = jnp.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n.z)
    b = n.x * n.y * a
    t = V3(1.0 + s * n.x * n.x * a, s * b, -s * n.x)
    bt = V3(b, s + n.y * n.y * a, -n.y)
    return t, bt


def local_to_world_c(local: V3, n: V3) -> V3:
    t, b = orthonormal_basis_c(n)
    return t * local.x + b * local.y + n * local.z


# ---------------------------------------------------------------------------
# RNG (mirror of sampling.rand2 — same hashes, same constants)
# ---------------------------------------------------------------------------


def rand2_c(pixel_id, frame, dim_pair):
    """(u1, u2) low-discrepancy pair; equals sampling.rand2(...) unstacked."""
    seed = pixel_seed(pixel_id, dim_pair)
    shuffled = owen_scramble(jnp.asarray(frame).astype(U32),
                             hash_combine(seed, U32(0x4D595DF4)))
    x = owen_scramble(_sobol_dim0(shuffled), hash_combine(seed, U32(0x968B6B5A)))
    y = owen_scramble(_sobol_dim1(shuffled), hash_combine(seed, U32(0x6E62F19B)))
    return _to_unit_float(x), _to_unit_float(y)


def rand2_bn_c(bnx, bny, frame, dim_pair):
    """Blue-noise-dithered pair: component twin of sampling.rand2_bn —
    shared Owen-Sobol sequence + per-pixel CP rotation (bnx/bny mask
    offsets, passed as dense lane arrays; zero gathers)."""
    from .sampling import _dim_shift
    u1, u2 = rand2_c(U32(0), frame, dim_pair)
    sx, sy = _dim_shift(dim_pair)
    ox = bnx + sx
    oy = bny + sy
    u = u1 + (ox - jnp.floor(ox))
    v = u2 + (oy - jnp.floor(oy))
    return u - jnp.floor(u), v - jnp.floor(v)


# ---------------------------------------------------------------------------
# warps (mirror of sampling.py)
# ---------------------------------------------------------------------------


def concentric_disk_c(u1, u2):
    ox = 2.0 * u1 - 1.0
    oy = 2.0 * u2 - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = jnp.abs(ox) > jnp.abs(oy)
    r = jnp.where(use_x, ox, oy)
    theta = jnp.where(
        use_x,
        (jnp.pi / 4.0) * (oy / jnp.where(ox == 0, 1.0, ox)),
        (jnp.pi / 2.0) - (jnp.pi / 4.0) * (ox / jnp.where(oy == 0, 1.0, oy)))
    px = r * jnp.cos(theta)
    py = r * jnp.sin(theta)
    return jnp.where(zero, 0.0, px), jnp.where(zero, 0.0, py)


def cosine_hemisphere_c(u1, u2) -> V3:
    dx, dy = concentric_disk_c(u1, u2)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - dx * dx - dy * dy))
    return V3(dx, dy, z)


def uniform_cone_c(u1, u2, cos_theta_max) -> V3:
    cos_t = (1.0 - u1) + u1 * cos_theta_max
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    phi = TWO_PI * u2
    return V3(jnp.cos(phi) * sin_t, jnp.sin(phi) * sin_t, cos_t)


def power_heuristic_c(f_pdf, g_pdf):
    f = f_pdf
    g = g_pdf
    return jnp.where(f + g > 0.0,
                     (f * f) / jnp.maximum(f * f + g * g, 1e-20), 0.0)


# ---------------------------------------------------------------------------
# GGX (mirror of bsdf.py; ggx_d / smith_g are reused — already elementwise)
# ---------------------------------------------------------------------------


def fresnel_schlick_c(cos_theta, f0: V3) -> V3:
    m = jnp.clip(1.0 - cos_theta, 0.0, 1.0)
    m5 = m * m * m * m * m
    return V3(f0.x + (1.0 - f0.x) * m5,
              f0.y + (1.0 - f0.y) * m5,
              f0.z + (1.0 - f0.z) * m5)


def ggx_sample_h_c(n: V3, wo: V3, u1, u2, alpha) -> V3:
    """VNDF visible-half-vector sample (mirror of bsdf.ggx_sample_h)."""
    t, b = orthonormal_basis_c(n)
    vx = vdot(wo, t)
    vy = vdot(wo, b)
    vz = jnp.maximum(vdot(wo, n), 1e-6)
    vhx, vhy, vhz = alpha * vx, alpha * vy, vz
    inv_len = jax.lax.rsqrt(jnp.maximum(vhx * vhx + vhy * vhy + vhz * vhz,
                                        1e-20))
    vhx, vhy, vhz = vhx * inv_len, vhy * inv_len, vhz * inv_len
    lensq = vhx * vhx + vhy * vhy
    invl = jax.lax.rsqrt(jnp.maximum(lensq, 1e-20))
    ok = lensq > 1e-12
    t1x = jnp.where(ok, -vhy * invl, 1.0)
    t1y = jnp.where(ok, vhx * invl, 0.0)
    t2x = -vhz * t1y
    t2y = vhz * t1x
    t2z = vhx * t1y - vhy * t1x
    r = jnp.sqrt(u1)
    phi = 2.0 * jnp.pi * u2
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vhz)
    p2 = (1.0 - s) * jnp.sqrt(jnp.maximum(0.0, 1.0 - p1 * p1)) + s * p2
    p3 = jnp.sqrt(jnp.maximum(0.0, 1.0 - p1 * p1 - p2 * p2))
    nhx = p1 * t1x + p2 * t2x + p3 * vhx
    nhy = p1 * t1y + p2 * t2y + p3 * vhy
    nhz = p2 * t2z + p3 * vhz
    hx, hy, hz = alpha * nhx, alpha * nhy, jnp.maximum(nhz, 1e-6)
    inv_h = jax.lax.rsqrt(jnp.maximum(hx * hx + hy * hy + hz * hz, 1e-20))
    hx, hy, hz = hx * inv_h, hy * inv_h, hz * inv_h
    return t * hx + b * hy + n * hz


def ggx_eval_c(n: V3, wo: V3, wi: V3, albedo: V3, f0: V3, alpha):
    """f and the VNDF sampling pdf (mirror of bsdf.ggx_eval)."""
    h = vnormalize(wo + wi)
    n_dot_v = jnp.maximum(vdot(n, wo), 0.0)
    n_dot_l = jnp.maximum(vdot(n, wi), 0.0)
    n_dot_h = jnp.maximum(vdot(n, h), 0.0)
    v_dot_h = jnp.maximum(vdot(wo, h), 0.0)
    d = ggx_d(n_dot_h, alpha)
    g = smith_g2(n_dot_v, n_dot_l, alpha)
    f_spec = fresnel_schlick_c(v_dot_h, f0)
    scale = d * g / jnp.maximum(4.0 * n_dot_v * n_dot_l, 1e-6)
    f = f_spec * albedo * scale
    pdf = smith_g1(n_dot_v, alpha) * d / jnp.maximum(4.0 * n_dot_v, 1e-6)
    valid = (n_dot_l > 0.0) & (n_dot_v > 0.0)
    zero = v3_const(0.0, 0.0, 0.0)
    return vwhere(valid, f, zero), jnp.where(valid, pdf, 0.0)


# ---------------------------------------------------------------------------
# unified sample / eval (mirror of bsdf.sample_bsdf / eval_bsdf)
# ---------------------------------------------------------------------------


class BsdfSampleC(NamedTuple):
    wi: V3
    weight: V3
    pdf: Any
    is_delta: Any


def sample_bsdf_c(mtype, albedo: V3, roughness, ior, f0: V3, n: V3, wo: V3,
                  inside, u1, u2) -> BsdfSampleC:
    alpha = jnp.maximum(roughness * roughness, 1e-4)

    wi_lam = local_to_world_c(cosine_hemisphere_c(u1, u2), n)
    pdf_lam = jnp.maximum(vdot(n, wi_lam), 0.0) * INV_PI

    wi_mir = reflect_c(-wo, n)

    eta_rel = jnp.where(inside, ior, 1.0 / ior)
    cos_i = jnp.maximum(vdot(wo, n), 0.0)
    fr = fresnel_dielectric(cos_i, 1.0 / jnp.maximum(eta_rel, 1e-6))
    refr_dir, tir = refract_c(-wo, n, eta_rel)
    choose_refl = (u1 < fr) | tir
    wi_gls = vwhere(choose_refl, reflect_c(-wo, n), refr_dir)

    h = ggx_sample_h_c(n, wo, u1, u2, alpha)
    wi_ggx = reflect_c(-wo, h)
    f_ggx, pdf_ggx = ggx_eval_c(n, wo, wi_ggx, albedo, f0, alpha)
    cos_ggx = jnp.maximum(vdot(n, wi_ggx), 0.0)
    ggx_ok = pdf_ggx > 1e-7
    w_ggx = vwhere(ggx_ok, f_ggx * (cos_ggx / jnp.maximum(pdf_ggx, 1e-7)),
                   v3_const(0.0, 0.0, 0.0))

    wi = vwhere(mtype == MAT_LAMBERT, wi_lam,
                vwhere(mtype == MAT_MIRROR, wi_mir,
                       vwhere(mtype == MAT_GLASS, wi_gls, wi_ggx)))
    weight = vwhere(mtype == MAT_LAMBERT, albedo,
                    vwhere(mtype == MAT_MIRROR, albedo,
                           vwhere(mtype == MAT_GLASS, albedo, w_ggx)))
    pdf = jnp.where(mtype == MAT_LAMBERT, pdf_lam,
                    jnp.where(mtype == MAT_GGX, pdf_ggx, 1.0))
    is_delta = (mtype == MAT_MIRROR) | (mtype == MAT_GLASS)
    return BsdfSampleC(vnormalize(wi), weight, pdf, is_delta)


def eval_bsdf_c(mtype, albedo: V3, roughness, f0: V3, n: V3, wo: V3, wi: V3):
    alpha = jnp.maximum(roughness * roughness, 1e-4)
    cos_l = jnp.maximum(vdot(n, wi), 0.0)

    f_lam = albedo * INV_PI
    pdf_lam = cos_l * INV_PI

    f_ggx, pdf_ggx = ggx_eval_c(n, wo, wi, albedo, f0, alpha)

    zero = v3_const(0.0, 0.0, 0.0)
    f = vwhere(mtype == MAT_LAMBERT, f_lam,
               vwhere(mtype == MAT_GGX, f_ggx, zero))
    pdf = jnp.where(mtype == MAT_LAMBERT, pdf_lam,
                    jnp.where(mtype == MAT_GGX, pdf_ggx, 0.0))
    valid = cos_l > 0.0
    return vwhere(valid, f, zero), jnp.where(valid, pdf, 0.0)


# ---------------------------------------------------------------------------
# sun NEE (mirror of light.sample_sun / sun_pdf_dir + sky.sun_disk_radiance)
# ---------------------------------------------------------------------------


class SunParamsC(NamedTuple):
    """Scalar sun-state bundle (unpacked from SMEM inside the kernel)."""

    dir: V3        # unit sun direction
    t: V3          # sun frame tangent
    b: V3          # sun frame bitangent
    trans: V3      # transmittance toward the sun
    intensity: Any  # scalar
    cos_theta_max: Any  # scalar (cone)


def _sun_common(sun: SunParamsC):
    disk_omega = 2.0 * jnp.pi * (1.0 - sun.cos_theta_max)
    cone_pdf = 1.0 / jnp.maximum(disk_omega, 1e-8)
    return disk_omega, cone_pdf


def sun_disk_radiance_c(sun: SunParamsC, d: V3) -> V3:
    cos_g = vdot(d, sun.dir)
    in_cone = cos_g > sun.cos_theta_max
    sin2 = jnp.maximum(1.0 - cos_g * cos_g, 0.0)
    sin2_max = 1.0 - sun.cos_theta_max * sun.cos_theta_max
    mu = jnp.sqrt(jnp.maximum(1.0 - sin2 / sin2_max, 0.0))
    limb = 1.0 - 0.6 * (1.0 - mu)
    disk_omega, _ = _sun_common(sun)
    s = (sun.intensity / disk_omega) * limb
    rad = sun.trans * s
    return vwhere(in_cone, rad, v3_const(0.0, 0.0, 0.0))


def sample_sun_c(sun: SunParamsC, u1, u2):
    """Returns (wi V3, radiance V3, pdf) — mirror of light.sample_sun
    (dist is always inf for the sun; callers treat it so)."""
    local = uniform_cone_c(u1, u2, sun.cos_theta_max)
    wi = vnormalize(sun.t * local.x + sun.b * local.y + sun.dir * local.z)
    rad = sun_disk_radiance_c(sun, wi)
    _, cone_pdf = _sun_common(sun)
    up = sun.dir.y > -0.05
    rad = vwhere(up, rad, v3_const(0.0, 0.0, 0.0))
    pdf = jnp.broadcast_to(cone_pdf, wi.x.shape)
    return wi, rad, pdf


def sun_pdf_dir_c(sun: SunParamsC, d: V3):
    cos_g = vdot(d, sun.dir)
    in_cone = cos_g > sun.cos_theta_max
    up = sun.dir.y > -0.05
    _, cone_pdf = _sun_common(sun)
    return jnp.where(in_cone & up, cone_pdf, 0.0)


# ---------------------------------------------------------------------------
# procedural soil texture (mirror of proctex.py)
# ---------------------------------------------------------------------------


def _hash3_c(ix, iy, iz, seed):
    h = (ix.astype(U32) * U32(0x8DA6B343)
         ^ iy.astype(U32) * U32(0xD8163841)
         ^ iz.astype(U32) * U32(0xCB1AB31F)) + U32(seed)
    h ^= h >> 15
    h *= U32(0x2C1B3C6D)
    h ^= h >> 12
    h *= U32(0x297A2D39)
    h ^= h >> 15
    return (h >> 8).astype(jnp.int32).astype(jnp.float32) \
        * jnp.float32(INV_2POW24)


def value_noise3_c(px, py, pz, seed: int):
    fx = jnp.floor(px)
    fy = jnp.floor(py)
    fz = jnp.floor(pz)
    ix = fx.astype(jnp.int32)
    iy = fy.astype(jnp.int32)
    iz = fz.astype(jnp.int32)
    rx = px - fx
    ry = py - fy
    rz = pz - fz
    wx = rx * rx * rx * (rx * (rx * 6.0 - 15.0) + 10.0)
    wy = ry * ry * ry * (ry * (ry * 6.0 - 15.0) + 10.0)
    wz = rz * rz * rz * (rz * (rz * 6.0 - 15.0) + 10.0)

    def h(dx, dy, dz):
        return _hash3_c(ix + dx, iy + dy, iz + dz, seed)

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


def fbm3_filtered_c(px, py, pz, cone_width, octaves: int, base_freq: float,
                    seed: int, gain: float = 0.5):
    total = jnp.zeros_like(px)
    norm = 0.0
    amp = 1.0
    freq = base_freq
    for k in range(octaves):
        fade = jnp.clip(1.0 - cone_width * freq * 1.5, 0.0, 1.0)
        n = value_noise3_c(px * freq, py * freq, pz * freq, seed + k * 131)
        total = total + amp * (0.5 + (n - 0.5) * fade)
        norm += amp
        amp *= gain
        freq *= 2.0
    return total / norm


def soil_shading_c(pos: V3, ns: V3, cone_width, world_scale: float = 0.35):
    """Mirror of proctex.soil_shading -> (albedo*ao V3, rough, normal V3)."""
    px = pos.x * world_scale
    py = pos.y * world_scale
    pz = pos.z * world_scale
    cw = cone_width * world_scale
    h = fbm3_filtered_c(px, py, pz, cw, 4, 1.0, seed=101)
    detail = fbm3_filtered_c(px, py, pz, cw, 3, 6.0, seed=202)

    t = jnp.clip(h * 1.4 - 0.2, 0.0, 1.0)
    alb = v3_const(0.23, 0.15, 0.09) * (1.0 - t) \
        + v3_const(0.42, 0.30, 0.18) * t
    t2 = jnp.clip(detail * 1.2 - 0.3, 0.0, 1.0)
    alb = alb * (1.0 - 0.4 * t2) + v3_const(0.55, 0.47, 0.35) * (0.4 * t2)
    ao = jnp.clip(0.55 + 0.45 * h, 0.0, 1.0)

    rough = jnp.clip(0.55 + 0.4 * detail + 0.15 * (1.0 - h), 0.05, 1.0)

    bump_fade = jnp.clip(1.0 - cw * 8.0, 0.0, 1.0)
    bx = fbm3_filtered_c(px + 17.17, py + 17.17, pz + 17.17, cw, 2, 5.0,
                         seed=303)
    by = fbm3_filtered_c(px + 29.29, py + 29.29, pz + 29.29, cw, 2, 5.0,
                         seed=404)
    bz = fbm3_filtered_c(px + 43.43, py + 43.43, pz + 43.43, cw, 2, 5.0,
                         seed=505)
    bump = V3(bx - 0.5, by - 0.5, bz - 0.5)
    n2 = vnormalize(ns + bump * (0.8 * bump_fade))
    return alb * ao, rough, n2


# ---------------------------------------------------------------------------
# material table select (mirror of bsdf.material_lookup, scalar-row form)
# ---------------------------------------------------------------------------

# packed material row layout (render/megakernel.py builds this):
# [0]=mtype [1:4]=albedo [4:7]=emission [7]=roughness [8]=ior [9:12]=f0
# [12]=textured
MAT_ROW = 16


def pack_materials_rows(materials):
    """Materials NamedTuple -> (M, MAT_ROW) f32 row table (traceable)."""
    m = materials.mtype.shape[0]
    f32 = jnp.float32
    return jnp.concatenate([
        materials.mtype.astype(f32)[:, None],
        materials.albedo.astype(f32),
        materials.emission.astype(f32),
        materials.roughness.astype(f32)[:, None],
        materials.ior.astype(f32)[:, None],
        materials.f0.astype(f32),
        materials.textured.astype(f32)[:, None],
        jnp.zeros((m, MAT_ROW - 13), f32)], axis=1)


def material_select_c(read_row, n_materials: int, mat):
    """Branchless material resolve from scalar rows.

    read_row(i) -> (MAT_ROW,) scalar row for material i (e.g. a ref read
    inside a kernel, or table[i] outside).  mat: lane i32 ids.
    Returns (mtype i32, albedo V3, rough, ior, f0 V3, emission V3, textured).
    """
    zero = jnp.zeros_like(mat, jnp.float32)
    mtype = jnp.zeros_like(mat)
    albedo = V3(zero, zero, zero)
    emission = V3(zero, zero, zero)
    f0 = V3(zero, zero, zero)
    rough = zero
    ior = jnp.ones_like(mat, jnp.float32)
    # accumulate the textured flag as f32 — a bool-vector select against a
    # scalar operand lowers to an unsupported i8->i1 truncation on Mosaic
    tex_f = zero
    for i in range(n_materials):
        r = read_row(i)
        sel = mat == i
        mtype = jnp.where(sel, r[0].astype(jnp.int32), mtype)
        albedo = vwhere(sel, V3(r[1], r[2], r[3]), albedo)
        emission = vwhere(sel, V3(r[4], r[5], r[6]), emission)
        rough = jnp.where(sel, r[7], rough)
        ior = jnp.where(sel, r[8], ior)
        f0 = vwhere(sel, V3(r[9], r[10], r[11]), f0)
        tex_f = jnp.where(sel, r[12], tex_f)
    return mtype, albedo, rough, ior, f0, emission, tex_f != 0.0


# ---------------------------------------------------------------------------
# normal orientation (mirror of integrator._orient_normals)
# ---------------------------------------------------------------------------


def orient_normals_c(ns_raw: V3, ng_raw: V3, wo: V3):
    ng = vnormalize(ng_raw)
    ns = vnormalize(ns_raw)
    flip = jnp.sign(vdot(ng, wo))
    flip = jnp.where(flip == 0.0, 1.0, flip)
    ng = ng * flip
    ns = ns * jnp.sign(vdot(ns, ng))
    ns = vwhere(vdot(ns, wo) > 0.0, ns, ng)
    return ns, ng


# ---------------------------------------------------------------------------
# analytic sphere-light helpers (mirror of integrator sphere-light path)
# ---------------------------------------------------------------------------


def ray_sphere_c(org: V3, d: V3, center: V3, radius):
    """Mirror of core/geometry.ray_sphere -> (hit mask, t)."""
    oc = org - center
    b = vdot(oc, d)
    c = vdot(oc, oc) - radius * radius
    disc = b * b - c
    ok = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = jnp.where(t0 > 1e-4, t0, t1)
    hit = ok & (t > 1e-4)
    return hit, jnp.where(hit, t, jnp.inf)


def uniform_cone_pdf_c(cos_theta_max):
    return 1.0 / (TWO_PI * jnp.maximum(1.0 - cos_theta_max, 1e-8))


def sphere_lights_pdf_c(read_light, n_lights: int, org: V3, d: V3):
    """Mirror of integrator._sphere_lights_pdf over scalar light rows.

    read_light(i) -> (8,) row [cx cy cz radius ex ey ez pad]."""
    pdf = jnp.zeros_like(d.x)
    for li in range(n_lights):
        r = read_light(li)
        c = V3(r[0], r[1], r[2])
        to_c = c - org
        d2 = jnp.maximum(vdot(to_c, to_c), 1e-8)
        sin2 = jnp.clip(r[3] * r[3] / d2, 0.0, 0.9999)
        cos_max = jnp.sqrt(1.0 - sin2)
        inv_dist = jax.lax.rsqrt(d2)
        cosg = vdot(d, to_c * inv_dist)
        pdf = pdf + jnp.where(cosg > cos_max,
                              uniform_cone_pdf_c(cos_max) / n_lights, 0.0)
    return pdf


def sample_sphere_light_c(read_light, n_lights: int, li, p: V3, u1, u2):
    """Mirror of light.sample_sphere_light with lane-varying light index li
    (selected by where-chain over the static light count).
    Returns (wi V3, radiance V3, pdf, dist)."""
    zero = jnp.zeros_like(p.x)
    c = V3(zero, zero, zero)
    radius = zero
    em = V3(zero, zero, zero)
    for i in range(n_lights):
        r = read_light(i)
        sel = li == i
        c = vwhere(sel, V3(r[0], r[1], r[2]), c)
        radius = jnp.where(sel, r[3], radius)
        em = vwhere(sel, V3(r[4], r[5], r[6]), em)
    to_c = c - p
    d2 = jnp.maximum(vdot(to_c, to_c), 1e-8)
    dist = jnp.sqrt(d2)
    axis = to_c * (1.0 / dist)
    sin2_max = jnp.clip(radius * radius / d2, 0.0, 0.9999)
    cos_max = jnp.sqrt(1.0 - sin2_max)
    local = uniform_cone_c(u1, u2, cos_max)
    wi = vnormalize(local_to_world_c(local, axis))
    pdf = jnp.broadcast_to(uniform_cone_pdf_c(cos_max), wi.x.shape)
    # distance to the sphere surface along wi (the cone cap), exactly as
    # light.sample_sphere_light computes it
    hit_dist = dist * local.z - jnp.sqrt(
        jnp.maximum(radius * radius - d2 * (1.0 - local.z * local.z), 0.0))
    return wi, em, pdf, jnp.maximum(hit_dist, 0.0)
