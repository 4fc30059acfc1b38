"""Morton (Z-order) codes for spatial sorting.

Counterpart of the reference's morton assignment
(reference: src/updateGeometry.cuh:13-27 for the 30-bit runtime code,
tool/meshProcessor.cpp:36-64 for the 60-bit offline baker code).
Pure bit math on int arrays — fully vectorized.
"""

from __future__ import annotations

import jax.numpy as jnp


def expand_bits_30(x):
    """Spread the low 10 bits of x so consecutive bits are 3 apart (uint32)."""
    x = x.astype(jnp.uint32) & jnp.uint32(0x3FF)
    x = (x | (x << 16)) & jnp.uint32(0x030000FF)
    x = (x | (x << 8)) & jnp.uint32(0x0300F00F)
    x = (x | (x << 4)) & jnp.uint32(0x030C30C3)
    x = (x | (x << 2)) & jnp.uint32(0x09249249)
    return x


def morton3d_30(p):
    """30-bit morton code of points normalized to [0,1]^3: (...,3) -> (...,) uint32."""
    q = jnp.clip(p * 1024.0, 0.0, 1023.0).astype(jnp.uint32)
    return (expand_bits_30(q[..., 0]) << 2) | (expand_bits_30(q[..., 1]) << 1) \
        | expand_bits_30(q[..., 2])


def expand_bits_63(x):
    """Spread the low 21 bits of x 3 apart (uint64)."""
    x = x.astype(jnp.uint64) & jnp.uint64(0x1FFFFF)
    x = (x | (x << 32)) & jnp.uint64(0x1F00000000FFFF)
    x = (x | (x << 16)) & jnp.uint64(0x1F0000FF0000FF)
    x = (x | (x << 8)) & jnp.uint64(0x100F00F00F00F00F)
    x = (x | (x << 4)) & jnp.uint64(0x10C30C30C30C30C3)
    x = (x | (x << 2)) & jnp.uint64(0x1249249249249249)
    return x


def morton3d_63(p):
    """63-bit morton code (offline mesh baker precision): (...,3) -> (...,) uint64."""
    q = jnp.clip(p * 2097152.0, 0.0, 2097151.0).astype(jnp.uint64)
    return (expand_bits_63(q[..., 0]) << 2) | (expand_bits_63(q[..., 1]) << 1) \
        | expand_bits_63(q[..., 2])


def normalize_to_aabb(p, lo, hi, eps=1e-12):
    """Normalize points into an AABB's unit cube (degenerate axes -> 0.5)."""
    ext = hi - lo
    safe = jnp.maximum(ext, eps)
    u = (p - lo) / safe
    return jnp.where(ext > eps, u, 0.5)
