"""The image-quality gates: denoised 1-spp stream vs CONVERGED self-render.

VERDICT round 1: self-pinned goldens catch regressions but not wrongness.
This module compares against a converged reference: accumulate an N-spp
converged reference with the denoiser off, then assert the denoised
1-spp stream reaches the recorded SSIM level — for a STATIC camera and
for an ORBITING camera (reference golden-dump workflow:
src/kernel.cuh:44-45).

Thresholds (r4, CORRECTED metric): the r1-r3 "SSIM >= 0.98" figures were
void (data_range=255 on [0,1] images saturates SSIM — ADVICE r3).  With
data_range=1.0 the measured steady states are 0.7223 static / 0.7054
orbit at this noise-dominated 96x54 resolution, and 0.93 at product
resolution (PARITY.md, where the >= 0.90 product bar lives).  The gates
here are REGRESSION gates pinned slightly under the measured values.

The converged reference is computed fresh (no pinned files): frame_idx
advances the low-discrepancy sequence, so averaging N raw frames = an
N-spp render.  Runs the portable wavefront path; CPU-friendly resolution.
"""

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtrt_tpu.core.camera import make_camera
from rtrt_tpu.denoise.pipeline import init_history
from rtrt_tpu.engine.frame import FrameState, FrameStatic, render_frame
from rtrt_tpu.engine.scene import build_demo_scene, padded_arrays
from rtrt_tpu.post.exposure import init_exposure_state
from rtrt_tpu.render.sky import (bake_sky_maps, finalize_sky_maps,
                                 make_sky_params)
from rtrt_tpu.render.texture import make_soil_textures
from rtrt_tpu.utils.config import FeatureFlags, default_params
from rtrt_tpu.utils.ssim import ssim

# slow tier: converged-reference fixtures render 24 raw frames per camera — fast CI tier runs `pytest -m "not slow"`
pytestmark = pytest.mark.slow

W, H = 96, 54
N_REF = 24          # reference spp (averaged raw frames)


@pytest.fixture(scope="module")
def setup():
    scene = build_demo_scene()
    pad = padded_arrays(scene)
    sky = finalize_sky_maps(jax.jit(lambda p: bake_sky_maps(
        p, sky_res=(32, 64), sun_res=(8, 8)))(make_sky_params()))
    tex = make_soil_textures(32)

    def mk(flags):
        st = FrameStatic(render_w=W, render_h=H, screen_w=W, screen_h=H,
                         num_batches=scene.num_batches, flags=flags)
        return jax.jit(partial(render_frame, st))

    def state0():
        return FrameState(vertices=jnp.asarray(scene.vertices),
                          normals=jnp.asarray(scene.normals),
                          history=init_history(H, W),
                          exposure=init_exposure_state(),
                          frame_idx=jnp.uint32(0), time=jnp.float32(0.0))

    def args(st, cam, prev):
        return (jnp.asarray(pad["indices"]), jnp.asarray(pad["tri_mat"]),
                jnp.asarray(pad["valid"]), scene.materials, tex, sky,
                scene.lights, st, cam, prev, default_params(),
                jnp.float32(1 / 60))

    raw = mk(FeatureFlags(denoise=False, postprocess=False))
    den = mk(FeatureFlags(postprocess=False))

    def converged(cam):
        st = state0()
        acc = np.zeros((H, W, 3))
        for _ in range(N_REF):
            img, st = raw(*args(st, cam, cam))
            acc += (np.asarray(img) / 255.0) ** 2.2
        return (acc / N_REF) ** (1 / 2.2)

    return den, args, state0, converged


def _orbit_cam(i):
    ang = 0.02 * i
    r = 9.0
    return make_camera(pos=(r * math.sin(ang), 3.0, -r * math.cos(ang)),
                       yaw=ang, pitch=-0.15)


def test_static_stream_reaches_converged(setup):
    den, args, state0, converged = setup
    cam = make_camera(pos=(0.0, 3.0, -9.0), pitch=-0.15)
    ref = converged(cam)
    st = state0()
    for _ in range(8):
        img, st = den(*args(st, cam, cam))
    s = ssim((np.asarray(img) / 255.0).astype(np.float64),
             ref.astype(np.float64), data_range=1.0)
    assert s >= 0.70, f"static denoised SSIM vs {N_REF}-spp = {s:.4f}"


def test_orbit_stream_reaches_converged(setup):
    """Moving camera: multi-pixel/frame motion.  History must survive
    reprojection (round-1 restarted accumulation every frame beyond ±1 px)
    and the stream must still track the converged render at the final
    pose."""
    den, args, state0, converged = setup
    k = 12
    ref = converged(_orbit_cam(k - 1))
    st = state0()
    counts = []
    for i in range(k):
        img, st = den(*args(st, _orbit_cam(i), _orbit_cam(max(i - 1, 0))))
        # history.count is stored bf16 — mean() in bf16 saturates (the
        # running sum sticks at 256), so upcast before reducing
        counts.append(float(np.asarray(st.history.count,
                                       dtype=np.float64).mean()))
    s = ssim((np.asarray(img) / 255.0).astype(np.float64),
             ref.astype(np.float64), data_range=1.0)
    assert s >= 0.68, f"orbit denoised SSIM vs {N_REF}-spp = {s:.4f}"
    # accumulation must GROW under motion (measured: 1.0 -> ~7.2, cap 8.3)
    assert counts[7] > 5.0, f"count stalled under orbit: {counts}"
    assert counts[7] > counts[3] > counts[0]
