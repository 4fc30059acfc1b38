"""Interlaced sparse rendering (engine/frame.py, FrameStatic.interlace).

Each frame traces HALF the pixel rows (y = 2i + frame parity) and the
reconstruction interleaves traced rows with vertical-neighbor fills before
the full-res denoise chain — a counterpart of the reference's
resolution/perf trade (dynamic resolution, reference: src/kernel.cu:78-114).

Two levels:
  - `interleave_rows` unit semantics.
  - traced-row parity through the frame's trace route (the XLA reference
    here; the GPU kernel is per-lane too): the interlaced frame's traced
    rows must equal the same rows of a full-rate render — same pixel ids
    => same blue-noise offsets, jitter, rays, hits, shading.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtrt_tpu.engine.frame import FrameStatic, FrameState, interleave_rows, \
    render_frame
from rtrt_tpu.utils.config import FeatureFlags, default_params


def test_interleave_rows_placement():
    a = jnp.arange(12, dtype=jnp.float32).reshape(3, 4)
    b = -jnp.arange(12, dtype=jnp.float32).reshape(3, 4)
    out = np.asarray(interleave_rows(a, b))
    assert out.shape == (6, 4)
    np.testing.assert_array_equal(out[0::2], np.asarray(a))
    np.testing.assert_array_equal(out[1::2], np.asarray(b))


def test_interleave_rows_int_and_3d():
    a = jnp.full((2, 4, 3), 7, jnp.int32)
    b = jnp.full((2, 4, 3), -1, jnp.int32)
    out = np.asarray(interleave_rows(a, b))
    assert out.dtype == np.int32 and out.shape == (4, 4, 3)
    assert (out[0::2] == 7).all() and (out[1::2] == -1).all()


# ---------------------------------------------------------------------------
# frame-level parity on the trace route

W, H = 48, 24


@pytest.fixture(scope="module")
def setup():
    from rtrt_tpu.core.camera import make_camera
    from rtrt_tpu.denoise.pipeline import init_history
    from rtrt_tpu.engine.scene import build_demo_scene, padded_arrays
    from rtrt_tpu.post.exposure import init_exposure_state
    from rtrt_tpu.render.sky import (bake_sky_maps, finalize_sky_maps,
                                     make_sky_params)
    from rtrt_tpu.render.texture import make_soil_textures

    scene = build_demo_scene()
    pad = padded_arrays(scene)
    sky = finalize_sky_maps(jax.jit(lambda p: bake_sky_maps(
        p, sky_res=(16, 32), sun_res=(4, 4)))(make_sky_params()))
    textures = make_soil_textures(16)
    state = FrameState(vertices=jnp.asarray(scene.vertices),
                       normals=jnp.asarray(scene.normals),
                       history=init_history(H, W),
                       exposure=init_exposure_state(),
                       frame_idx=jnp.uint32(0),
                       time=jnp.float32(0.0))
    cam = make_camera(pos=(0.0, 3.0, -9.0), pitch=-0.15)
    args = (jnp.asarray(pad["indices"]), jnp.asarray(pad["tri_mat"]),
            jnp.asarray(pad["valid"]), scene.materials, textures, sky,
            scene.lights, state, cam, cam, default_params(),
            jnp.float32(1 / 60))
    return scene, args, state


def _trace_fn(scene, interlace):
    from functools import partial
    static = FrameStatic(
        render_w=W, render_h=H, screen_w=W, screen_h=H,
        num_batches=scene.num_batches, flags=FeatureFlags(),
        trace="xla", interlace=interlace, stop_after="trace")
    return jax.jit(partial(render_frame, static))


@pytest.mark.slow
def test_interlaced_traced_rows_exact(setup):
    scene, args, state = setup
    full = _trace_fn(scene, False)
    half = _trace_fn(scene, True)

    (c_f, a_f, n_f, d_f, m_f, mo_f), _ = full(*args)
    (c_h, a_h, n_h, d_h, m_h, mo_h), _ = half(*args)
    assert c_h.shape == c_f.shape == (H, W, 3)

    # frame 0 => parity 0 => traced rows are the even rows.  Traversal and
    # shading are per-lane, so only XLA's fusion of the different array
    # shapes may move the last bits
    for fa, ha in ((c_f, c_h), (a_f, a_h), (n_f, n_h), (d_f, d_h),
                   (m_f, m_h), (mo_f, mo_h)):
        np.testing.assert_allclose(np.asarray(ha)[0::2],
                                   np.asarray(fa)[0::2], rtol=5e-4, atol=5e-4)

    # odd parity: frame 1 traces the odd rows, exact
    state1 = state._replace(frame_idx=jnp.uint32(1))
    args1 = args[:7] + (state1,) + args[8:]
    (c_f1, *_), _ = full(*args1)
    (c_h1, *_), _ = half(*args1)
    np.testing.assert_allclose(np.asarray(c_h1)[1::2],
                               np.asarray(c_f1)[1::2], rtol=5e-4, atol=5e-4)

    # filled rows: parity-0 linear fill of radiance rows 2i+1 is the mean
    # of traced rows 2i and 2i+2 (last fill clamps)
    ch = np.asarray(c_h)
    expect = 0.5 * (ch[0:-2:2] + ch[2::2])
    np.testing.assert_allclose(ch[1:-1:2], expect, rtol=1e-5, atol=1e-6)
    # nearest fill for geometry planes: row 2i+1 replicates row 2i
    np.testing.assert_array_equal(np.asarray(d_h)[1::2],
                                  np.asarray(d_h)[0::2])
