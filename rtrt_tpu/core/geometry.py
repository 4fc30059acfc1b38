"""Geometric primitives and ray-primitive intersectors (batched, branchless).

Counterpart of the reference's primitive types and intersector
library (reference: src/geometry.h:5-158, src/geometry.cuh:18-620).  Every
intersector here is written mask-based over arbitrary leading batch dims so
it vectorizes across lanes — there is no scalar early-out; misses are
encoded as `hit=False` / `t=+inf`.

Primitives are plain arrays (SoA), not structs:
  * AABB:      lo (...,3), hi (...,3)
  * Ray:       org (...,3), dir (...,3)  (+ precomputed helpers, see RayAux)
  * Triangle:  v0/v1/v2 (...,3)
  * Sphere:    center (...,3), radius (...)
  * Plane:     normal (...,3), offset (...)   [dot(n, p) = offset]
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .precision import GAMMA3
from .vecmath import cross, dot, permute3

INF = jnp.float32(jnp.inf)
RAY_TMIN = jnp.float32(1e-4)


# ---------------------------------------------------------------------------
# ray auxiliary precomputation
# ---------------------------------------------------------------------------


class RayAux(NamedTuple):
    """Per-ray precomputed quantities shared across all node/leaf tests.

    `inv_dir` feeds the AABB slab test; (kx,ky,kz,sx,sy,sz) are the watertight
    triangle test's max-dimension permutation + shear constants
    (reference: src/geometry.cuh:406-430, src/geometry.cuh:497-583).
    """

    inv_dir: jnp.ndarray  # (...,3)
    kx: jnp.ndarray  # (...,) int32
    ky: jnp.ndarray
    kz: jnp.ndarray
    sx: jnp.ndarray  # (...,) f32 shear
    sy: jnp.ndarray
    sz: jnp.ndarray


def make_ray_aux(dir):
    d = dir
    tiny = jnp.float32(1e-20)
    safe_d = jnp.where(jnp.abs(d) < tiny, jnp.where(d >= 0, tiny, -tiny), d)
    inv_dir = 1.0 / safe_d

    kz = jnp.argmax(jnp.abs(d), axis=-1).astype(jnp.int32)
    kx = (kz + 1) % 3
    ky = (kz + 2) % 3
    # preserve winding: swap kx/ky when the major component is negative
    dz = jnp.take_along_axis(d, kz[..., None], axis=-1)[..., 0]
    neg = dz < 0.0
    kx, ky = jnp.where(neg, ky, kx), jnp.where(neg, kx, ky)

    dp = permute3(safe_d, kx, ky, kz)
    sz = 1.0 / dp[..., 2]
    sx = dp[..., 0] * sz
    sy = dp[..., 1] * sz
    return RayAux(inv_dir, kx, ky, kz, sx, sy, sz)


# ---------------------------------------------------------------------------
# AABB
# ---------------------------------------------------------------------------


def aabb_union(lo_a, hi_a, lo_b, hi_b):
    return jnp.minimum(lo_a, lo_b), jnp.maximum(hi_a, hi_b)


def aabb_center(lo, hi):
    return 0.5 * (lo + hi)


def aabb_empty(shape=(), dtype=jnp.float32):
    lo = jnp.full(shape + (3,), jnp.inf, dtype)
    hi = jnp.full(shape + (3,), -jnp.inf, dtype)
    return lo, hi


def ray_aabb(org, inv_dir, lo, hi, t_min=RAY_TMIN, t_max=INF):
    """Slab test.  Returns (hit, t_near).  Conservative: tfar scaled by
    1+2*gamma(3) so grazing rays are not missed (PBRT robustness rule).

    Uses sign-selected near/far planes instead of per-axis min/max so that
    EMPTY boxes (lo=+inf, hi=-inf — our padding sentinel) correctly MISS:
    the swapped form would invert the degenerate interval into (-inf, +inf)
    and hit everything."""
    neg = inv_dir < 0.0
    near_plane = jnp.where(neg, hi, lo)
    far_plane = jnp.where(neg, lo, hi)
    tnear = jnp.max((near_plane - org) * inv_dir, axis=-1)
    tfar = jnp.min((far_plane - org) * inv_dir, axis=-1) * (1.0 + 2.0 * GAMMA3)
    hit = (tnear <= tfar) & (tfar > t_min) & (tnear < t_max)
    return hit, jnp.maximum(tnear, t_min)


def ray_aabb_pair(org, inv_dir, boxes12, t_min=RAY_TMIN, t_max=INF):
    """Test a ray against the two child boxes packed in one node row.

    `boxes12` is (...,12): [Llo(3), Lhi(3), Rlo(3), Rhi(3)] — the analog of the
    reference's AABBCompact pair test (reference: src/geometry.cuh:603-628),
    which amortizes one node fetch over two box tests.
    Returns (hitL, tL, hitR, tR).
    """
    hl, tl = ray_aabb(org, inv_dir, boxes12[..., 0:3], boxes12[..., 3:6], t_min, t_max)
    hr, tr = ray_aabb(org, inv_dir, boxes12[..., 6:9], boxes12[..., 9:12], t_min, t_max)
    return hl, tl, hr, tr


# ---------------------------------------------------------------------------
# triangle
# ---------------------------------------------------------------------------


class TriHit(NamedTuple):
    hit: jnp.ndarray  # (...,) bool
    t: jnp.ndarray  # (...,) f32 (inf on miss)
    u: jnp.ndarray  # barycentric of v1
    v: jnp.ndarray  # barycentric of v2


def ray_triangle_watertight(org, aux: RayAux, v0, v1, v2,
                            t_min=RAY_TMIN, t_max=INF) -> TriHit:
    """Watertight ray/triangle test (Woop-Benthin-Wald, JCGT 2013).

    Double-sided (no backface culling), as the reference's default intersector
    (reference: src/geometry.cuh:406-474).  The shear constants come from
    `make_ray_aux`; edge-function sign agreement guarantees watertightness
    along shared edges.
    """
    a = permute3(v0 - org, aux.kx, aux.ky, aux.kz)
    b = permute3(v1 - org, aux.kx, aux.ky, aux.kz)
    c = permute3(v2 - org, aux.kx, aux.ky, aux.kz)

    sx, sy, sz = aux.sx, aux.sy, aux.sz
    ax = a[..., 0] - sx * a[..., 2]
    ay = a[..., 1] - sy * a[..., 2]
    bx = b[..., 0] - sx * b[..., 2]
    by = b[..., 1] - sy * b[..., 2]
    cx = c[..., 0] - sx * c[..., 2]
    cy = c[..., 1] - sy * c[..., 2]

    u = cx * by - cy * bx
    v = ax * cy - ay * cx
    w = bx * ay - by * ax

    same_sign = ((u >= 0) & (v >= 0) & (w >= 0)) | ((u <= 0) & (v <= 0) & (w <= 0))
    det = u + v + w

    az = sz * a[..., 2]
    bz = sz * b[..., 2]
    cz = sz * c[..., 2]
    t_scaled = u * az + v * bz + w * cz

    # sign-safe range check: t in (t_min, t_max) with t = t_scaled/det
    det_sign = jnp.sign(det)
    ts = t_scaled * det_sign
    absdet = jnp.abs(det)
    in_range = (ts > t_min * absdet) & (ts < t_max * absdet)

    hit = same_sign & (det != 0.0) & in_range
    inv_det = jnp.where(det != 0.0, 1.0 / det, 0.0)
    t = jnp.where(hit, t_scaled * inv_det, INF)
    return TriHit(hit, t, v * inv_det, w * inv_det)


def ray_triangle_mt(org, dir, v0, v1, v2, t_min=RAY_TMIN, t_max=INF) -> TriHit:
    """Moller-Trumbore (double-sided) — CPU-oracle / test intersector
    (reference analog: src/geometry.cuh:267-301)."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = cross(dir, e2)
    det = dot(e1, p)
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = org - v0
    u = dot(tvec, p) * inv_det
    q = cross(tvec, e1)
    v = dot(dir, q) * inv_det
    t = dot(e2, q) * inv_det
    hit = (jnp.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & \
        (t > t_min) & (t < t_max)
    return TriHit(hit, jnp.where(hit, t, INF), u, v)


def triangle_normal(v0, v1, v2):
    """Geometric (unnormalized) normal with CCW winding."""
    return cross(v1 - v0, v2 - v0)


def triangle_aabb(v0, v1, v2, pad=1e-6):
    """Per-triangle AABB, epsilon-padded like the reference
    (reference: src/updateGeometry.cuh:176-177)."""
    lo = jnp.minimum(jnp.minimum(v0, v1), v2) - pad
    hi = jnp.maximum(jnp.maximum(v0, v1), v2) + pad
    return lo, hi


# ---------------------------------------------------------------------------
# sphere / plane
# ---------------------------------------------------------------------------


def ray_sphere(org, dir, center, radius, t_min=RAY_TMIN, t_max=INF):
    """Returns (hit, t) for the nearest positive root
    (reference analog: src/geometry.cuh:18-70)."""
    oc = org - center
    b = dot(oc, dir)
    c = dot(oc, oc) - radius * radius
    disc = b * b - c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = jnp.where((t0 > t_min) & (t0 < t_max), t0,
                  jnp.where((t1 > t_min) & (t1 < t_max), t1, INF))
    hit = (disc > 0.0) & jnp.isfinite(t)
    return hit, jnp.where(hit, t, INF)


def ray_plane(org, dir, normal, offset, t_min=RAY_TMIN, t_max=INF):
    """Plane dot(n,p)=offset (reference analog: src/geometry.cuh:225-266)."""
    dn = dot(dir, normal)
    t = (offset - dot(org, normal)) / jnp.where(jnp.abs(dn) > 1e-12, dn, 1e-12)
    hit = (jnp.abs(dn) > 1e-12) & (t > t_min) & (t < t_max)
    return hit, jnp.where(hit, t, INF)
