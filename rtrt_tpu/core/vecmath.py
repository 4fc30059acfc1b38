"""Vector / matrix math on JAX arrays.

Replacement for the reference's header-only CUDA math library
(reference: src/linearMath.h:100-748).  Instead of scalar Float3/Mat3 structs,
everything here operates on batched arrays whose *trailing* axis holds the
vector components — the natural SoA layout for vectorized lanes.

Conventions:
  * vectors: (..., 3) float32 arrays (or (...,2)/(...,4) where noted)
  * matrices: (..., 3, 3) / (..., 4, 4); `matvec` broadcasts over leading dims
  * quaternions: (..., 4) as (w, x, y, z)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# vector helpers
# ---------------------------------------------------------------------------


def vec3(x, y, z, dtype=jnp.float32):
    """Build a (..., 3) vector by stacking broadcastable components."""
    return jnp.stack(jnp.broadcast_arrays(
        jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype)), axis=-1)


def dot(a, b):
    """Component dot product over the trailing axis, keeps no dims: (...,)."""
    return jnp.sum(a * b, axis=-1)


def dotk(a, b):
    """Dot product keeping the trailing axis as size 1 (for broadcasting)."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def cross(a, b):
    return jnp.cross(a, b)


def length(a):
    return jnp.sqrt(jnp.maximum(dot(a, a), 0.0))


def length_sq(a):
    return dot(a, a)


def normalize(a, eps: float = 1e-20):
    """Safe normalize; zero vectors map to zero (not NaN)."""
    n2 = dotk(a, a)
    return a * jnp.where(n2 > eps, jnp.reciprocal(jnp.sqrt(jnp.maximum(n2, eps))), 0.0)


def distance(a, b):
    return length(a - b)


def lerp(a, b, t):
    return a + (b - a) * t


def clamp(x, lo=0.0, hi=1.0):
    return jnp.clip(x, lo, hi)


def saturate(x):
    return jnp.clip(x, 0.0, 1.0)


def reflect(d, n):
    """Reflect direction `d` about normal `n` (both (...,3); d points in)."""
    return d - 2.0 * dotk(d, n) * n


def refract(d, n, eta):
    """Refract `d` through surface with normal `n` and relative IOR `eta`
    (n_incident / n_transmitted).  Returns (refracted_dir, total_internal_refl).

    `d` points toward the surface; `n` opposes `d` (cos_i = -dot(d, n) > 0).
    On total internal reflection the returned direction is the reflection.
    """
    eta = jnp.asarray(eta)[..., None] if jnp.ndim(eta) == jnp.ndim(d) - 1 else eta
    cos_i = -dotk(d, n)
    sin2_t = eta * eta * jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    tir = (sin2_t >= 1.0)[..., 0]
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_t))
    refr = eta * d + (eta * cos_i - cos_t) * n
    refl = reflect(d, n)
    return jnp.where(tir[..., None], refl, refr), tir


def project(a, b):
    """Project a onto b."""
    return b * (dotk(a, b) / jnp.maximum(dotk(b, b), 1e-20))


def abs_max_component_index(v):
    """Index (0/1/2) of the largest-|.| component: (...,) int32."""
    return jnp.argmax(jnp.abs(v), axis=-1).astype(jnp.int32)


def permute3(v, kx, ky, kz):
    """Gather components of a (...,3) vector by per-element axis indices.

    kx/ky/kz are (...,) int32 in {0,1,2}.  Used by the watertight triangle
    test's max-dimension permutation (reference: src/geometry.cuh:406-423).
    Implemented with selects (avoids a per-lane gather).
    """
    def pick(k):
        return jnp.where(k[..., None] == 0, v[..., 0:1],
                         jnp.where(k[..., None] == 1, v[..., 1:2], v[..., 2:3]))
    return jnp.concatenate([pick(kx), pick(ky), pick(kz)], axis=-1)


def orthonormal_basis(n):
    """Build tangent/bitangent for unit normal n — branchless Frisvad/Duff.

    Returns (t, b) with [t, b, n] right-handed orthonormal.
    """
    s = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = vec3(1.0 + s * n[..., 0] * n[..., 0] * a, s * b, -s * n[..., 0])
    bt = vec3(b, s + n[..., 1] * n[..., 1] * a, -n[..., 1])
    return t, bt


def local_to_world(local, n):
    """Map a (...,3) direction in the tangent frame of unit normal n to world."""
    t, b = orthonormal_basis(n)
    return (local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n)


def spherical_to_dir(theta, phi):
    """(theta from +z, phi around z) -> unit vector."""
    st = jnp.sin(theta)
    return vec3(st * jnp.cos(phi), st * jnp.sin(phi), jnp.cos(theta))


# ---------------------------------------------------------------------------
# matrices
# ---------------------------------------------------------------------------


def matvec(m, v):
    """(...,N,N) @ (...,N) -> (...,N).  Full float32: a GPU would otherwise
    run it in TF32 (~3 decimal digits) and perturb directions and colors."""
    return jnp.einsum("...ij,...j->...i", m, v,
                      precision=jax.lax.Precision.HIGHEST)


def mat3_from_axis_angle(axis, angle):
    """Rodrigues rotation matrix, axis (...,3) unit, angle (...,) radians."""
    axis = jnp.asarray(axis, jnp.float32)
    angle = jnp.asarray(angle, jnp.float32)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    c, s = jnp.cos(angle), jnp.sin(angle)
    t = 1.0 - c
    rows = [
        jnp.stack([t * x * x + c, t * x * y - s * z, t * x * z + s * y], -1),
        jnp.stack([t * x * y + s * z, t * y * y + c, t * y * z - s * x], -1),
        jnp.stack([t * x * z - s * y, t * y * z + s * x, t * z * z + c], -1),
    ]
    return jnp.stack(rows, axis=-2)


def rotate_axis_angle(v, axis, angle):
    return matvec(mat3_from_axis_angle(axis, angle), v)


def mat4_translate(t):
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, 3].set(jnp.asarray(t, jnp.float32))


def mat4_scale(s):
    s = jnp.asarray(s, jnp.float32)
    return jnp.diag(jnp.concatenate([jnp.broadcast_to(s, (3,)), jnp.ones(1)]))


def mat4_from_mat3(m3):
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, :3].set(m3)


def transform_point(m4, p):
    """Apply a (...,4,4) homogeneous transform to (...,3) points."""
    r = matvec(m4[..., :3, :3], p) + m4[..., :3, 3]
    return r


def transform_dir(m4, d):
    return matvec(m4[..., :3, :3], d)


# ---------------------------------------------------------------------------
# quaternions (w, x, y, z)
# ---------------------------------------------------------------------------


def quat_from_axis_angle(axis, angle):
    half = jnp.asarray(angle, jnp.float32) * 0.5
    return jnp.concatenate(
        [jnp.cos(half)[..., None], jnp.asarray(axis) * jnp.sin(half)[..., None]], axis=-1)


def quat_mul(q1, q2):
    w1, x1, y1, z1 = (q1[..., i] for i in range(4))
    w2, x2, y2, z2 = (q2[..., i] for i in range(4))
    return jnp.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def quat_rotate(q, v):
    """Rotate (...,3) v by unit quaternion q."""
    qv = q[..., 1:4]
    w = q[..., 0:1]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


# ---------------------------------------------------------------------------
# compensated (Kahan) accumulation — reference: linearMath.h CompensatedFloat
# ---------------------------------------------------------------------------


def kahan_add(total, comp, value):
    """One Kahan step; returns (new_total, new_comp)."""
    y = value - comp
    t = total + y
    return t, (t - total) - y
