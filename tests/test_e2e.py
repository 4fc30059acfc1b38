"""End-to-end frame tests: the full fused pipeline at tiny resolution.

The analog of the reference's golden-frame dumps (reference: DUMP_FRAME_NUM
at src/kernel.cuh:44-45): render the demo scene through the real frame
program (LBVH rebuild -> path trace -> denoise -> postprocess -> u8) and
assert structural image properties + determinism.  Runs the portable XLA
wavefront path (CPU); the GPU traversal kernel is checked against it in
tests/test_lane_traverse.py and on the card by chip_smoke.py.
"""

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

# slow tier: full fused-pipeline frames (multi-minute compile on CPU) — fast CI tier runs `pytest -m "not slow"`
pytestmark = pytest.mark.slow

W, H = 96, 54


@pytest.fixture(scope="module")
def frame_setup():
    scene = build_demo_scene()
    pad = padded_arrays(scene)
    static = FrameStatic(render_w=W, render_h=H, screen_w=W, screen_h=H,
                         num_batches=scene.num_batches,
                         flags=FeatureFlags())
    sky = finalize_sky_maps(jax.jit(lambda p: bake_sky_maps(
        p, sky_res=(32, 64), sun_res=(8, 8)))(make_sky_params()))
    textures = make_soil_textures(32)
    state = FrameState(vertices=jnp.asarray(scene.vertices),
                       normals=jnp.asarray(scene.normals),
                       history=init_history(H, W),
                       exposure=init_exposure_state(),
                       frame_idx=jnp.uint32(0),
                       time=jnp.float32(0.0))
    cam = make_camera(pos=(0.0, 3.0, -9.0), pitch=-0.15)
    from functools import partial
    fn = jax.jit(partial(render_frame, static))
    args = (jnp.asarray(pad["indices"]), jnp.asarray(pad["tri_mat"]),
            jnp.asarray(pad["valid"]), scene.materials, textures, sky,
            scene.lights, state, cam, cam, default_params(),
            jnp.float32(1 / 60))
    return fn, args, state


def test_frame_structure(frame_setup):
    fn, args, state = frame_setup
    img, new_state = fn(*args)
    a = np.asarray(img)
    assert a.shape == (H, W, 3) and a.dtype == np.uint8
    # sky at the top: bright and blue-ish
    top = a[:H // 6].mean(axis=(0, 1))
    assert top[2] >= top[0] - 2 and top.mean() > 80
    # ground in the lower half: lit, roughly neutral
    bottom = a[int(H * 0.75):].mean()
    assert bottom > 60
    # spheres present: the center band is darker/more varied than plain ground
    band = a[int(H * 0.55):int(H * 0.7)]
    assert band.std() > 10
    # frame counter advanced, history valid
    assert int(new_state.frame_idx) == 1
    assert bool(new_state.history.valid)


def test_frame_deterministic(frame_setup):
    fn, args, _ = frame_setup
    img1, _ = fn(*args)
    img2, _ = fn(*args)
    np.testing.assert_array_equal(np.asarray(img1), np.asarray(img2))


def test_temporal_chain_converges(frame_setup):
    """Threading history over frames must reduce frame-to-frame change."""
    fn, args, state = frame_setup
    args = list(args)
    img_prev = None
    diffs = []
    for i in range(8):
        img, new_state = fn(*args)
        args[7] = new_state  # FrameState slot
        a = np.asarray(img).astype(np.int32)
        if img_prev is not None:
            diffs.append(np.abs(a - img_prev).mean())
        img_prev = a
    # later frames differ less than early ones (accumulation works); mean
    # over windows, not single pairs — per-frame sample noise swings a
    # single diff by ~±1 gray level at this tiny resolution
    early = np.mean(diffs[:2])
    late = np.mean(diffs[-4:])
    assert late < early, (early, late, diffs)
    assert late < 12.0


def test_golden_image(frame_setup):
    """Pin the first demo frame against the repo's golden PNG (SSIM).

    The reference pins PPM dumps for offline diffing (DUMP_FRAME_NUM);
    SSIM >= 0.98 is BASELINE.json's image metric.  Guards cross-round
    regressions of the whole pipeline on the portable path.
    """
    import os
    from rtrt_tpu.utils.image import read_png
    from rtrt_tpu.utils.ssim import ssim
    path = os.path.join(os.path.dirname(__file__), "golden",
                        "demo_96x54_frame0.png")
    if not os.path.exists(path):
        pytest.skip("golden image not generated")
    fn, args, _ = frame_setup
    img, _ = fn(*args)
    golden = read_png(path)
    s = ssim(np.asarray(img).astype(np.float64),
             golden.astype(np.float64))
    assert s >= 0.98, f"SSIM vs golden = {s:.4f}"


def test_prebuilt_tables_match_rebuild(frame_setup):
    """The Engine's static-scene prebuilt BVH/attribute tables must render
    bit-identically to the in-frame rebuild (engine/frame.py:prebuilt)."""
    from rtrt_tpu.engine.frame import build_scene_tables
    fn, args, _ = frame_setup
    img_rebuild, _ = fn(*args)
    scene = build_demo_scene()
    prebuilt = build_scene_tables(scene.num_batches, args[0], args[1],
                                  args[2], args[7].vertices,
                                  args[7].normals)
    img_pre, _ = fn(*args, prebuilt)
    np.testing.assert_array_equal(np.asarray(img_rebuild),
                                  np.asarray(img_pre))
