"""Pinhole + thin-lens camera model and reprojection.

Counterpart of the reference camera
(reference: src/kernel.cuh:78-155, src/init.cu:412-439).  The camera is a
small pytree of scalars/vectors; the orthonormal basis is derived pure-math
inside jit, so moving the camera never retraces the frame function.

World convention: right-handed, +y up, yaw about +y, pitch about the right
axis.  Screen uv in [0,1]^2 with (0,0) at the top-left pixel corner.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .vecmath import cross, dotk, normalize, vec3

WORLD_UP = jnp.array([0.0, 1.0, 0.0], jnp.float32)


class Camera(NamedTuple):
    """Dynamic camera state — every field is a traced array (no recompiles)."""

    pos: jnp.ndarray        # (3,)
    yaw: jnp.ndarray        # () radians
    pitch: jnp.ndarray      # () radians
    fov_y: jnp.ndarray      # () vertical field of view, radians
    aperture: jnp.ndarray   # () lens radius (0 = pinhole)
    focal_dist: jnp.ndarray  # () focus distance


def make_camera(pos=(0.0, 2.0, -5.0), yaw=0.0, pitch=0.0, fov_y=1.0,
                aperture=0.0, focal_dist=5.0) -> Camera:
    f = lambda x: jnp.asarray(x, jnp.float32)
    return Camera(f(jnp.array(pos)), f(yaw), f(pitch), f(fov_y), f(aperture),
                  f(focal_dist))


class CameraBasis(NamedTuple):
    pos: jnp.ndarray      # (3,)
    forward: jnp.ndarray  # (3,) unit
    right: jnp.ndarray    # (3,) unit
    up: jnp.ndarray       # (3,) unit
    tan_half_fov_y: jnp.ndarray  # ()
    aperture: jnp.ndarray
    focal_dist: jnp.ndarray


def camera_basis(cam: Camera) -> CameraBasis:
    cp, sp = jnp.cos(cam.pitch), jnp.sin(cam.pitch)
    cy, sy = jnp.cos(cam.yaw), jnp.sin(cam.yaw)
    forward = vec3(cp * sy, sp, cp * cy)
    right = normalize(cross(forward, WORLD_UP))
    up = cross(right, forward)
    return CameraBasis(cam.pos, forward, right, up,
                       jnp.tan(0.5 * cam.fov_y), cam.aperture, cam.focal_dist)


def pixel_to_dir(basis: CameraBasis, uv, aspect):
    """Map screen uv in [0,1]^2 (+ aspect = W/H) to a world-space unit ray dir.

    uv is (...,2); returns (...,3).
    """
    ndc_x = (uv[..., 0] * 2.0 - 1.0) * aspect * basis.tan_half_fov_y
    ndc_y = (1.0 - uv[..., 1] * 2.0) * basis.tan_half_fov_y
    d = (basis.forward + ndc_x[..., None] * basis.right
         + ndc_y[..., None] * basis.up)
    return normalize(d)


def world_to_screen(basis: CameraBasis, p, aspect):
    """Project world points (...,3) to screen uv (...,2) + view depth (...,).

    Counterpart of the reference's WorldToScreenSpace used for motion vectors
    and the lens-flare sun position (reference: src/kernel.cuh:123-133).
    Points behind the camera get depth <= 0 (uv is then meaningless).
    """
    rel = p - basis.pos
    z = dotk(rel, basis.forward)[..., 0]
    safe_z = jnp.where(jnp.abs(z) > 1e-6, z, 1e-6)
    x = dotk(rel, basis.right)[..., 0] / (safe_z * basis.tan_half_fov_y * aspect)
    y = dotk(rel, basis.up)[..., 0] / (safe_z * basis.tan_half_fov_y)
    u = (x + 1.0) * 0.5
    v = (1.0 - y) * 0.5
    return jnp.stack([u, v], axis=-1), z


def motion_vector(prev_basis: CameraBasis, cur_uv, world_pos, aspect):
    """Screen-space motion vector: uv_prev - uv_cur for a static world point.

    Counterpart of the reference's HistoryCamera reprojection
    (reference: src/kernel.cuh:135-155, src/pathtrace.cuh:76-82).
    Returns (...,2); zero where the point was behind the previous camera.
    """
    prev_uv, prev_z = world_to_screen(prev_basis, world_pos, aspect)
    mv = prev_uv - cur_uv
    return jnp.where((prev_z > 0.0)[..., None], mv, 0.0)
