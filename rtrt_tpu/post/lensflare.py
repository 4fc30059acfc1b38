"""Procedural lens flare: ghosts, rings, and sun streaks.

Counterpart of the reference's LensFlare (reference:
src/postprocessing.cuh:415-488).  The reference uses CUDA *dynamic
parallelism* — a 1-thread predicate kernel reads the depth at the sun pixel
and device-launches the flare kernel when the sky is visible (:482-488).
Here that becomes a traced visibility scalar multiplying the flare layer
(branch-free; XLA's fusion makes the always-computed flare essentially free
at 1/1 res of a few analytic shapes).

Geometry: artifacts are placed along the line from the sun's screen position
through the image center (the classic ghost axis).
"""

from __future__ import annotations

import jax.numpy as jnp


def _smooth_circle(d2, radius, soft):
    return jnp.clip(1.0 - (jnp.sqrt(jnp.maximum(d2, 1e-12)) - radius) / soft,
                    0.0, 1.0)


def lens_flare(h: int, w: int, sun_uv, sun_visible, strength):
    """Returns an additive (H,W,3) flare layer.

    sun_uv: (2,) sun position in screen uv; sun_visible: () 0/1 traced
    scalar (depth-at-sun-pixel test done by the caller); strength: user gain.
    """
    ys = (jnp.arange(h, dtype=jnp.float32) + 0.5) / h
    xs = (jnp.arange(w, dtype=jnp.float32) + 0.5) / w
    yy, xx = jnp.meshgrid(ys, xs, indexing="ij")
    aspect = w / h
    # work in aspect-corrected coords so circles stay circular
    px = (xx - 0.5) * aspect
    py = yy - 0.5
    sx = (sun_uv[0] - 0.5) * aspect
    sy = sun_uv[1] - 0.5

    acc = jnp.zeros((h, w, 3), jnp.float32)

    # halo around the sun
    d2s = (px - sx) ** 2 + (py - sy) ** 2
    halo = jnp.exp(-d2s * 60.0)
    acc += halo[..., None] * jnp.array([1.0, 0.85, 0.6]) * 0.8

    # streaks through the sun (horizontal + diagonal)
    for ang, amp in ((0.0, 0.35), (1.5707963, 0.2), (0.7853982, 0.12)):
        ca, sa = jnp.cos(ang), jnp.sin(ang)
        along = (px - sx) * ca + (py - sy) * sa
        across = -(px - sx) * sa + (py - sy) * ca
        streak = jnp.exp(-across * across * 4000.0) * \
            jnp.exp(-along * along * 6.0)
        acc += streak[..., None] * jnp.array([1.0, 0.9, 0.75]) * amp

    # ghost chain along the sun->center axis (reference's circles/hex ghosts)
    ghost_params = [(-0.4, 0.05, (0.4, 0.7, 1.0), 0.25),
                    (-0.8, 0.08, (0.9, 0.5, 1.0), 0.18),
                    (-1.3, 0.03, (0.4, 1.0, 0.6), 0.22),
                    (0.5, 0.10, (1.0, 0.6, 0.4), 0.10),
                    (1.6, 0.14, (0.5, 0.6, 1.0), 0.12)]
    for t, radius, col, amp in ghost_params:
        gx = -sx * t  # position along the mirrored sun->center axis
        gy = -sy * t
        d2 = (px - gx) ** 2 + (py - gy) ** 2
        ring = _smooth_circle(d2, radius, 0.02) * \
            (1.0 - _smooth_circle(d2, radius * 0.55, 0.03) * 0.6)
        acc += ring[..., None] * jnp.array(col) * (amp * 0.3)

    # fade the whole layer by sun visibility and off-screen distance
    on_screen = jnp.clip(1.5 - 2.0 * jnp.sqrt(sx * sx + sy * sy), 0.0, 1.0)
    return acc * (strength * sun_visible * on_screen)
