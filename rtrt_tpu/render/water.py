"""Ocean: iterative Gerstner-style wave heightfield + analytic shading.

Counterpart of the reference's dormant ocean feature
(reference: src/water.cuh:9-188 — iterative wave heightfield raymarch,
normal from finite differences, Fresnel water shading; gated by USE_OCEAN).

Shape: the heightfield is pure per-lane math (no textures), the
"raymarch" is a fixed-trip secant search for the y=height(x,z) crossing,
and shading blends sky reflection with depth-tinted water via Fresnel.
Enable by giving a material MAT_OCEAN-like hook or by evaluating
`ocean_shade` for rays that cross the water plane (engine-level feature).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.vecmath import dot, normalize, reflect, vec3

WAVE_ITERS = 5
MARCH_STEPS = 16


def wave_height(x, z, time):
    """Sum-of-waves heightfield (iterative domain-warped sines)."""
    h = jnp.zeros_like(x)
    amp = 0.5
    freq = 0.16
    dx = x
    dz = z
    for i in range(WAVE_ITERS):
        phase = dx * freq + dz * freq * 0.7 + time * (0.8 + 0.2 * i)
        w = jnp.sin(phase) * jnp.exp(jnp.cos(phase) - 1.0)
        h = h + amp * w
        # domain warp for choppiness
        dx = dx + jnp.cos(phase) * amp * 0.4
        dz = dz + jnp.sin(phase * 1.3) * amp * 0.3
        amp *= 0.55
        freq *= 1.9
    return h


def wave_normal(x, z, time, eps=0.05):
    hx0 = wave_height(x - eps, z, time)
    hx1 = wave_height(x + eps, z, time)
    hz0 = wave_height(x, z - eps, time)
    hz1 = wave_height(x, z + eps, time)
    return normalize(vec3(hx0 - hx1, 2.0 * eps, hz0 - hz1))


def intersect_ocean(org, dir, time, level=0.0, t_max=200.0):
    """Fixed-step march + refinement for the heightfield crossing.

    Returns (hit (N,), t (N,)); only for rays heading downward toward the
    surface region."""
    t0 = jnp.maximum((level + 1.5 - org[..., 1])
                     / jnp.minimum(dir[..., 1], -1e-4), 0.0)
    t = t0
    prev_t = t0
    prev_above = jnp.ones(org.shape[:-1], bool)
    found = jnp.zeros(org.shape[:-1], bool)
    hit_t = jnp.full(org.shape[:-1], jnp.inf)
    dt = (t_max - t0) / MARCH_STEPS
    lo_t = jnp.zeros_like(t)
    hi_t = jnp.zeros_like(t)
    for _ in range(MARCH_STEPS):
        p = org + dir * t[..., None]
        above = p[..., 1] > level + wave_height(p[..., 0], p[..., 2], time)
        newly = prev_above & ~above & ~found  # first surface crossing
        lo_t = jnp.where(newly, prev_t, lo_t)
        hi_t = jnp.where(newly, t, hi_t)
        found = found | newly
        prev_above = above
        prev_t = t
        t = t + dt
    # bisection refine the bracket
    for _ in range(8):
        mid = 0.5 * (lo_t + hi_t)
        p = org + dir * mid[..., None]
        above = p[..., 1] > level + wave_height(p[..., 0], p[..., 2], time)
        lo_t = jnp.where(above, mid, lo_t)
        hi_t = jnp.where(above, hi_t, mid)
    hit_t = 0.5 * (lo_t + hi_t)
    hit = found & (dir[..., 1] < 0.0)
    return hit, jnp.where(hit, hit_t, jnp.inf)


def ocean_shade(org, dir, t, time, sky_radiance_fn, level=0.0):
    """Fresnel blend of reflected sky and depth-tinted water color
    (reference OceanShader analog, water.cuh:127)."""
    p = org + dir * t[..., None]
    n = wave_normal(p[..., 0], p[..., 2], time)
    cos_i = jnp.clip(-dot(dir, n), 0.0, 1.0)
    f = 0.02 + 0.98 * (1.0 - cos_i) ** 5
    refl = sky_radiance_fn(normalize(reflect(dir, n)))
    deep = jnp.array([0.02, 0.08, 0.12], jnp.float32)
    shallow = jnp.array([0.1, 0.3, 0.35], jnp.float32)
    body = deep + (shallow - deep) * jnp.exp(-0.2 * jnp.maximum(t, 0.0))[..., None]
    return refl * f[..., None] + body * (1.0 - f[..., None])
