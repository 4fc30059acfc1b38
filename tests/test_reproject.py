"""Gather history reprojection: exact at whole-pixel motion, rejects
history that leaves the image, and accumulation survives multi-pixel motion
(the round-1 ±1 px stencil reset it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtrt_tpu.denoise.pipeline import DenoiseHistory, init_history
from rtrt_tpu.denoise.reproject import Reprojection, reproject_gather
from rtrt_tpu.denoise.temporal import temporal_filter
from rtrt_tpu.utils.config import default_params

H, W = 64, 160


def _history(rng):
    return (jnp.asarray(rng.uniform(0, 4, (H, W, 3)).astype(np.float32)),
            jnp.asarray(rng.uniform(0, 4, (H, W, 3)).astype(np.float32)),
            jnp.asarray(rng.uniform(1, 30, (H, W)).astype(np.float32)),
            jnp.asarray(rng.integers(0, 5, (H, W)).astype(np.int32)),
            jnp.asarray(rng.integers(0, 16, (H, W)).astype(np.float32)))


def _smooth_motion(rng, scale_px=5.0):
    """Smooth (camera-like) motion field, several pixels of magnitude."""
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W),
                         indexing="ij")
    a, b, c2, d = rng.uniform(-1, 1, 4)
    mx = (a + 0.3 * np.sin(2 * xx + b)) * scale_px / W
    my = (c2 + 0.3 * np.cos(2 * yy + d)) * scale_px / H
    return jnp.asarray(np.stack([mx, my], -1).astype(np.float32))


@pytest.mark.parametrize("dy,dx", [(0, 0), (0, 3), (5, -2)])
def test_gather_integer_shift_is_exact(rng, dy, dx):
    """At whole-pixel motion every filter tap but the centre has weight 0,
    so the reprojected history is the history shifted by (dy, dx)."""
    col, col2, dep, mat, cnt = _history(rng)
    motion = jnp.asarray(np.stack(
        [np.full((H, W), dx / W, np.float32),
         np.full((H, W), dy / H, np.float32)], -1))
    got: Reprojection = reproject_gather(col, col2, dep, mat, cnt, motion)
    ys = slice(max(0, -dy), H - max(0, dy))
    xs = slice(max(0, -dx), W - max(0, dx))
    src = lambda a: np.asarray(a)[max(0, dy):H - max(0, -dy),
                                  max(0, dx):W - max(0, -dx)]
    assert np.asarray(got.ok)[ys, xs].all()
    np.testing.assert_allclose(np.asarray(got.color)[ys, xs], src(col),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(got.color2)[ys, xs], src(col2),
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(got.mat_id)[ys, xs], src(mat))
    np.testing.assert_array_equal(np.asarray(got.depth)[ys, xs], src(dep))
    np.testing.assert_array_equal(np.asarray(got.count)[ys, xs], src(cnt))


def test_gather_rejects_motion_off_image(rng):
    """Pixels whose history position leaves the image report ok=False (the
    temporal filter then restarts them, SVGF disocclusion semantics)."""
    col, col2, dep, mat, cnt = _history(rng)
    motion = jnp.asarray(np.stack(
        [np.full((H, W), 10.0 / W, np.float32),
         np.zeros((H, W), np.float32)], -1))
    ok = np.asarray(reproject_gather(col, col2, dep, mat, cnt, motion).ok)
    assert not ok[:, W - 10:].any()
    assert ok[:, :W - 10].all()


def test_accumulation_survives_multi_pixel_pan(rng):
    """Accumulation count must keep GROWING under a 5 px/frame pan — the
    VERDICT round-1 failure mode was a reset every frame beyond ±1 px."""
    p = default_params().denoise
    color = jnp.asarray(rng.uniform(0, 1, (H, W, 3)).astype(np.float32))
    normal = jnp.zeros((H, W, 3), jnp.float32)
    depth = jnp.full((H, W), 5.0, jnp.float32)
    mat = jnp.ones((H, W), jnp.int32)
    motion = jnp.asarray(
        np.stack([np.full((H, W), 5.0 / W, np.float32),
                  np.zeros((H, W), np.float32)], -1))

    hist = DenoiseHistory(color=color, color2=color, depth=depth,
                          mat_id=mat, valid=jnp.asarray(True),
                          count=jnp.full((H, W), 7.0, jnp.float32))
    rep = reproject_gather(hist.color, hist.color2, hist.depth,
                           hist.mat_id, hist.count, motion)
    out, new_count = temporal_filter(
        color, normal, depth, mat, motion, hist.color, hist.depth,
        hist.mat_id, hist.valid, p, hist_count=hist.count,
        reproj=(rep.color, rep.depth, rep.mat_id, rep.count, rep.ok))
    nc = np.asarray(new_count)
    # interior pixels continue accumulating: count -> 8 (7 reprojected + 1)
    interior = nc[8:-8, 8:-8]
    assert (interior > 7.5).mean() > 0.95


@pytest.mark.slow
def test_denoise_pipeline_gather_mode_runs(rng):
    """The CPU-path denoise chain with gather reprojection stays finite."""
    from rtrt_tpu.denoise.pipeline import denoise
    from rtrt_tpu.utils.config import FeatureFlags
    color = jnp.asarray(rng.uniform(0, 1, (H, W, 3)).astype(np.float32))
    albedo = jnp.full((H, W, 3), 0.8, jnp.float32)
    normal = jnp.concatenate([jnp.zeros((H, W, 2)), jnp.ones((H, W, 1))],
                             -1).astype(jnp.float32)
    depth = jnp.full((H, W), 5.0, jnp.float32)
    mat = jnp.ones((H, W), jnp.int32)
    motion = _smooth_motion(rng, 3.0)
    hist = init_history(H, W)
    out, new_hist = jax.jit(
        lambda c, h: denoise(c, albedo, normal, depth, mat, motion, h,
                             default_params().denoise, FeatureFlags()))(color, hist)
    assert np.isfinite(np.asarray(out)).all()
    out2, _ = jax.jit(
        lambda c, h: denoise(c, albedo, normal, depth, mat, motion, h,
                             default_params().denoise, FeatureFlags()))(color, new_hist)
    assert np.isfinite(np.asarray(out2)).all()
