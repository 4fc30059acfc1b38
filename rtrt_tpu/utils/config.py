"""Configuration: TOML launch config + runtime-tunable parameter registry.

Counterpart of the reference's three config tiers (SURVEY.md §5.6):
  (a) TOML launch config -> `GlobalSettings`
      (reference: src/configLoader.cpp:5-28, src/globalSettings.h:5-22,
      resources/config.toml);
  (b) compile-time feature flags -> `FeatureFlags`, passed as *static* jit
      arguments (flag flips recompile the frame program, mirroring #define
      rebuilds at reference: src/kernel.cuh:37-67);
  (c) runtime-tunable parameter structs with a reflection scheme the UI
      consumes generically (reference: src/settingParams.h:26-158,
      src/ui.cpp:20-108) -> NamedTuple pytrees of traced scalars + a
      `param_registry` of (path, label, widget, min, max, log) tuples.

Uses stdlib tomllib; no third-party TOML dependency.

A fourth tier — RTRT_* environment knobs — exists for operators and
perf/debug tooling.  The COMPLETE registry:

  RTRT_SEGMENTS          bounce-program depth (default 5 scene intersects)
  RTRT_DEBUG             =1: live NaN guards + safe gathers in the frame
  RTRT_HISTORY_FILTER    history resampling: catmull_rom (default) |
                         bilinear (denoise/reproject.py)
  RTRT_PRECOMPILE        =0: disable background bucket precompiles
  RTRT_PREBUILD          =0: force the per-frame in-jit LBVH rebuild
  RTRT_LEAF_WIDTH        row-aligned SAH leaf width (default 8; 1 = off)
  RTRT_SAH               =0: static scenes prebuild the two-level morton
                         LBVH instead of the flat binned-SAH tree
  RTRT_INTERLACE         =1/0: interlaced sparse rendering override
                         (GlobalSettings.interlace is the API)
"""

from __future__ import annotations

import dataclasses
import tomllib
from typing import NamedTuple

import jax.numpy as jnp


# ---------------------------------------------------------------------------
# (a) launch config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DynamicResolution:
    enabled: bool = True
    target_fps: float = 60.0
    deadband_fps: float = 2.0
    min_width: int = 640
    max_width: int = 3840


@dataclasses.dataclass(frozen=True)
class GlobalSettings:
    render_width: int = 1920
    render_height: int = 1080
    window_width: int = 2560
    window_height: int = 1440
    scene: str = "terrain"          # terrain | mesh:<path> | demo
    mesh_path: str = ""
    camera_path: str = "camera.json"
    load_camera_at_init: bool = False
    texture_size: int = 512
    terrain_chunks: int = 4
    terrain_seed: int = 7
    terrain_style: str = "smooth"    # smooth (sub-voxel isosurface) |
    #   roundcube (reference template-mesh visual identity: flat block
    #   faces + rounded bevels, content/marching.py::roundcube_field)
    sky_model: str = "physical"      # physical (Rayleigh-Mie) | preetham
    #   (fitted analytic daylight — the reference's active-sky family)
    interlace: bool = False          # interlaced sparse rendering: trace
    #   half the pixel rows per frame (alternating parity), reconstruct
    #   full-res before the denoiser (engine/frame.py) — a perf/latency
    #   trade next to dynamic_resolution
    frame_cap_fps: float = 75.0      # reference: 75-fps busy-wait floor
    dynamic_resolution: DynamicResolution = dataclasses.field(
        default_factory=DynamicResolution)


def load_config(path: str | None) -> GlobalSettings:
    """TOML file -> GlobalSettings with defaults for missing keys."""
    if path is None:
        return GlobalSettings()
    with open(path, "rb") as f:
        t = tomllib.load(f)
    dr = t.get("dynamic_resolution", {})
    return GlobalSettings(
        render_width=t.get("render_width", 1920),
        render_height=t.get("render_height", 1080),
        window_width=t.get("window_width", 2560),
        window_height=t.get("window_height", 1440),
        scene=t.get("scene", "terrain"),
        mesh_path=t.get("mesh_path", ""),
        camera_path=t.get("camera_path", "camera.json"),
        load_camera_at_init=t.get("load_camera_at_init", False),
        texture_size=t.get("texture_size", 512),
        terrain_chunks=t.get("terrain_chunks", 4),
        terrain_seed=t.get("terrain_seed", 7),
        terrain_style=t.get("terrain_style", "smooth"),
        sky_model=t.get("sky_model", "physical"),
        interlace=t.get("interlace", False),
        frame_cap_fps=t.get("frame_cap_fps", 75.0),
        dynamic_resolution=DynamicResolution(
            enabled=dr.get("enabled", True),
            target_fps=dr.get("target_fps", 60.0),
            deadband_fps=dr.get("deadband_fps", 2.0),
            min_width=dr.get("min_width", 640),
            max_width=dr.get("max_width", 3840),
        ),
    )


# ---------------------------------------------------------------------------
# (b) static feature flags (jit static args — flips recompile)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FeatureFlags:
    """Structural render-pass toggles (the reference's RenderPassSettings,
    settingParams.h:26-60).  Hashable: used as a static jit argument."""

    denoise: bool = True
    temporal_filter: bool = True
    spatial_filter: bool = True
    second_temporal: bool = True
    postprocess: bool = True
    bloom: bool = True
    lens_flare: bool = True
    auto_exposure: bool = True
    sharpen: bool = True
    dither: bool = True
    textures: bool = True
    procedural_textures: bool = True  # analytic noise (zero-gather) vs mips
    rebuild_bvh_every_frame: bool = True
    blue_noise: bool = True  # inter-pixel blue-noise sample distribution
    half_history: bool = True  # bf16 persistent history buffers (the
    #   analog of the reference's half-precision history surfaces,
    #   src/fp16Utils.cuh + buffer formats at src/init.cu:473-500)
    ocean: bool = False  # raymarched wave-heightfield environment ocean
    #   (the reference's dormant USE_OCEAN chain, src/water.cuh via
    #   sky2.cuh:11 — here an active opt-in; render/environment.py)
    stars: bool = False  # procedural night star field (src/star.cuh twin)


# ---------------------------------------------------------------------------
# (c) runtime-tunable params (traced pytrees — no recompiles)
# ---------------------------------------------------------------------------


class SampleParams(NamedTuple):
    """reference: settingParams.h SampleParams block."""

    aperture: jnp.ndarray
    focal_dist: jnp.ndarray


class DenoiseParams(NamedTuple):
    """Sigmas/thresholds of the SVGF chain
    (reference: settingParams.h:122-158 DenoisingParams)."""

    sigma_normal: jnp.ndarray       # normal-weight exponent
    sigma_depth: jnp.ndarray        # depth gaussian width
    sigma_material: jnp.ndarray     # material-mask mismatch penalty
    temporal_blend: jnp.ndarray     # base history blend factor
    anti_flicker: jnp.ndarray       # clamp-box scale
    noise_threshold: jnp.ndarray    # tile noise gate
    noise_threshold_16: jnp.ndarray  # wide-filter gate


class PostParams(NamedTuple):
    """reference: settingParams.h PostProcessParams."""

    exposure_gain: jnp.ndarray
    manual_exposure: jnp.ndarray     # used when auto_exposure flag off
    bloom_strength: jnp.ndarray
    flare_strength: jnp.ndarray
    tone_map: jnp.ndarray            # 0 reinhard,1 aces_fitted,2 aces,3 uncharted2
    sharpen_amount: jnp.ndarray
    gamma: jnp.ndarray


class SkyTuning(NamedTuple):
    """Sun/sky controls; changing them triggers sky-map regeneration
    (reference: ui.cpp:41 needRegenerate)."""

    time_of_day: jnp.ndarray
    sun_axis_angle: jnp.ndarray
    sun_intensity: jnp.ndarray
    rayleigh: jnp.ndarray
    mie: jnp.ndarray
    mie_g: jnp.ndarray


class RenderParams(NamedTuple):
    sample: SampleParams
    denoise: DenoiseParams
    post: PostParams
    sky: SkyTuning


def default_params() -> RenderParams:
    f = lambda x: jnp.float32(x)
    return RenderParams(
        sample=SampleParams(aperture=f(0.0), focal_dist=f(10.0)),
        denoise=DenoiseParams(
            sigma_normal=f(64.0), sigma_depth=f(0.1), sigma_material=f(1.0),
            temporal_blend=f(0.12), anti_flicker=f(1.0),
            noise_threshold=f(0.001), noise_threshold_16=f(0.001)),
        post=PostParams(exposure_gain=f(1.0), manual_exposure=f(1.0),
                        bloom_strength=f(0.05), flare_strength=f(1.0),
                        tone_map=f(1.0), sharpen_amount=f(0.5), gamma=f(2.2)),
        sky=SkyTuning(time_of_day=f(0.35), sun_axis_angle=f(0.3),
                      sun_intensity=f(20.0), rayleigh=f(1.0), mie=f(1.0),
                      mie_g=f(0.76)),
    )


# Reflection registry: (pytree path, label, widget, min, max, log_scale) —
# consumed generically by the UI layer (reference: GetValueList tuples,
# settingParams.h:26-158).
PARAM_REGISTRY = [
    ("sample.aperture", "Aperture", "slider", 0.0, 0.5, False),
    ("sample.focal_dist", "Focal distance", "slider", 0.5, 100.0, True),
    ("denoise.sigma_normal", "Denoise: normal sigma", "slider", 1.0, 256.0, True),
    ("denoise.sigma_depth", "Denoise: depth sigma", "slider", 0.001, 1.0, True),
    ("denoise.sigma_material", "Denoise: material penalty", "slider", 0.0, 4.0, False),
    ("denoise.temporal_blend", "Denoise: temporal blend", "slider", 0.01, 1.0, False),
    ("denoise.anti_flicker", "Denoise: anti-flicker", "slider", 0.0, 4.0, False),
    ("denoise.noise_threshold", "Denoise: noise gate", "slider", 0.0, 0.01, False),
    ("post.exposure_gain", "Exposure gain", "slider", 0.1, 10.0, True),
    ("post.bloom_strength", "Bloom", "slider", 0.0, 0.3, False),
    ("post.flare_strength", "Lens flare", "slider", 0.0, 4.0, False),
    ("post.tone_map", "Tone mapper", "combo:reinhard,aces_fitted,aces,uncharted2",
     0, 3, False),
    ("post.sharpen_amount", "Sharpen", "slider", 0.0, 1.0, False),
    ("sky.time_of_day", "Time of day", "slider", 0.0, 1.0, False),
    ("sky.sun_axis_angle", "Sun axis angle", "slider", 0.0, 1.5, False),
    ("sky.sun_intensity", "Sun intensity", "slider", 1.0, 100.0, True),
    ("sky.rayleigh", "Rayleigh", "slider", 0.1, 4.0, False),
    ("sky.mie", "Mie", "slider", 0.1, 4.0, False),
    ("sky.mie_g", "Mie anisotropy", "slider", 0.0, 0.99, False),
]


def get_param(params: RenderParams, path: str):
    obj = params
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def set_param(params: RenderParams, path: str, value) -> RenderParams:
    """Functionally update one leaf by dotted path."""
    parts = path.split(".")

    def rec(obj, i):
        if i == len(parts):
            return jnp.float32(value)
        child = getattr(obj, parts[i])
        return obj._replace(**{parts[i]: rec(child, i + 1)})

    return rec(params, 0)
