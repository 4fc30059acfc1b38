"""Primary-ray generation: thin-lens camera rays + ray cones.

Counterpart of the reference's ray generation
(reference: src/raygen.cuh:7-64): blue-noise-jittered pixel position,
concentric-disk aperture sampling for depth of field, and the per-pixel
ray-cone angular width used for texture LOD selection.

Rays are produced as flat SoA arrays over the pixel grid — the wavefront
layout every downstream stage (traversal, shading, denoise scatter) consumes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core.camera import CameraBasis, pixel_to_dir
from ..core.vecmath import normalize
from .sampling import concentric_disk


class Rays(NamedTuple):
    org: jnp.ndarray         # (N,3)
    dir: jnp.ndarray         # (N,3) unit
    uv: jnp.ndarray          # (N,2) jittered screen uv (for reprojection)
    cone_width: jnp.ndarray  # (N,) angular width (radians/unit distance)


def pixel_grid(width: int, height: int):
    """Flat pixel-center coordinates: (N,2) float (x+0.5, y+0.5) and the
    (N,) int32 pixel ids used to seed the per-pixel sampler."""
    ys, xs = jnp.meshgrid(jnp.arange(height, dtype=jnp.float32),
                          jnp.arange(width, dtype=jnp.float32), indexing="ij")
    centers = jnp.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1)
    ids = (jnp.arange(width * height, dtype=jnp.int32))
    return centers, ids


def generate_rays(basis: CameraBasis, width: int, height: int,
                  jitter2, lens2) -> Rays:
    """Generate one primary ray per pixel.

    jitter2: (N,2) in [0,1) — subpixel jitter (low-discrepancy dims 0-1).
    lens2:   (N,2) in [0,1) — aperture sample (dims 2-3).
    """
    aspect = width / height
    centers, _ = pixel_grid(width, height)
    uv = (centers + jitter2) / jnp.array([width, height], jnp.float32)
    d = pixel_to_dir(basis, uv, aspect)

    # thin lens: offset origin on the aperture disk, refocus at focal_dist
    disk = concentric_disk(lens2) * basis.aperture
    offset = disk[..., 0:1] * basis.right + disk[..., 1:2] * basis.up
    focal_pt = basis.pos + d * basis.focal_dist
    org = basis.pos + offset
    d = normalize(focal_pt - org)

    # ray cone angular width: one-pixel vertical footprint
    # (reference: src/raygen.cuh:45-64)
    cone = jnp.full(d.shape[:-1], 2.0 * basis.tan_half_fov_y / height)
    return Rays(org, d, uv, cone)


def generate_rays_padded(basis: CameraBasis, width: int, height: int,
                         pixel_ids, jitter2, lens2) -> Rays:
    """Like generate_rays but for an explicit pixel-id list:
    pixel_ids (Np,) int32 (pad entries may repeat the last pixel)."""
    aspect = width / height
    px = (pixel_ids % width).astype(jnp.float32) + 0.5
    py = (pixel_ids // width).astype(jnp.float32) + 0.5
    uv = (jnp.stack([px, py], axis=-1) + jitter2 - 0.5) \
        / jnp.array([width, height], jnp.float32)
    d = pixel_to_dir(basis, uv, aspect)
    disk = concentric_disk(lens2) * basis.aperture
    offset = disk[..., 0:1] * basis.right + disk[..., 1:2] * basis.up
    focal_pt = basis.pos + d * basis.focal_dist
    org = basis.pos + offset
    d = normalize(focal_pt - org)
    cone = jnp.full(d.shape[:-1], 2.0 * basis.tan_half_fov_y / height)
    return Rays(org, d, uv, cone)
