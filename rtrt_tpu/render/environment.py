"""Composed environment: sky fit + optional star field + optional ocean.

In the reference, the dormant sky2 chain makes the ENVIRONMENT — not scene
geometry — carry the ocean surface and the night stars: GetEnvIncidentLight
(reference: src/sky2.cuh:75) raymarches the atmosphere, adds
StableStarField (src/star.cuh:33) above the horizon, and, behind
`USE_OCEAN` (sky2.cuh:11), resolves downward rays against OceanShader
(src/water.cuh:127).  This module is the active equivalent: escaped
rays resolve against sky + stars + raymarched ocean in one vectorized,
gather-free eval (flags are static — unused features compile to nothing).

Approximation note: escape rays that left the scene after k bounces carry
only their direction out of the trace kernels; the ocean march uses the
PRIMARY ray origins (camera) for all lanes.  For a camera above the water
and scene scales here the parallax error of a bounced escape ray is sub-
texel; the reference's dormant chain was never exercised, so there is no
behavioral bar to diverge from.
"""

from __future__ import annotations

import jax.numpy as jnp

from .sky import SkyMaps, env_radiance_fit
from .stars import star_field
from .water import intersect_ocean, ocean_shade


def night_visibility(maps: SkyMaps):
    """Star visibility in [0,1]: fades in as the sun sinks below the
    horizon (full at sun elevation <= -0.1, zero above +0.02)."""
    s = maps.sun_dir[1]
    return jnp.clip((0.02 - s) / 0.12, 0.0, 1.0)


def env_radiance_scene(maps: SkyMaps, org, d, time, *,
                       ocean: bool = False, stars: bool = False,
                       ocean_level: float = 0.0,
                       star_intensity: float = 0.5):
    """Environment radiance for escaped rays.

    maps: baked sky; org: (...,3) ray origins (primary — see module note);
    d: (...,3) unit escape directions; time: () f32 animation clock.
    ocean/stars are STATIC flags (part of the jit key via FeatureFlags).
    """
    env = env_radiance_fit(maps, d)
    if stars:
        vis = night_visibility(maps) * star_intensity
        above = (d[..., 1] > 0.0).astype(jnp.float32)
        env = env + star_field(d) * (vis * above)[..., None]

    if ocean:
        hit, t = intersect_ocean(org, d, time, level=ocean_level)
        # water reflections see the same composed sky (incl. the sun disk —
        # that is what makes the glints)
        shade = ocean_shade(org, d, jnp.where(hit, t, 0.0), time,
                            lambda dd: env_radiance_fit(maps, dd),
                            level=ocean_level)
        env = jnp.where(hit[..., None], shade, env)
    return env
