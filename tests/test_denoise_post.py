"""Tests: SVGF denoise chain + post-processing kernels vs numpy oracles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtrt_tpu.denoise.pipeline import denoise, init_history
from rtrt_tpu.denoise.spatial import spatial_filter_7x7, spatial_filter_wide
from rtrt_tpu.denoise.temporal import (temporal_filter, tile_noise_downsample,
                                       tile_noise_level)
from rtrt_tpu.ops.resize import downsample4, upscale_catmull_rom
from rtrt_tpu.ops.stencil import (bicubic_catmull_rom_sample, bilinear_sample,
                                  gaussian_weights, neighborhood, shifted)
from rtrt_tpu.post.bloom import bloom
from rtrt_tpu.post.exposure import (auto_exposure, init_exposure_state,
                                    log_luminance_histogram)
from rtrt_tpu.post.lensflare import lens_flare
from rtrt_tpu.post.sharpen import median3, sharpen
from rtrt_tpu.post.tonemap import (aces_approx, aces_fitted, reinhard_extended,
                                   tonemap, uncharted2)
from rtrt_tpu.utils.config import FeatureFlags, default_params

H, W = 48, 64


@pytest.fixture
def img(rng):
    return jnp.asarray(rng.uniform(0, 2, (H, W, 3)).astype(np.float32))


# ---------------------------------------------------------------------------
# stencil machinery
# ---------------------------------------------------------------------------


def test_shifted_matches_numpy(img):
    a = np.asarray(img)
    s = np.asarray(shifted(img, 2, -3))
    # out[y,x] = img[y+2, x-3] with edge clamp
    ref = a[np.clip(np.arange(H) + 2, 0, H - 1)][:, np.clip(np.arange(W) - 3, 0, W - 1)]
    np.testing.assert_allclose(s, ref)


def test_neighborhood_center(img):
    taps, offs = neighborhood(img, 1)
    assert taps.shape[0] == 9
    center = np.where((np.asarray(offs) == 0).all(axis=1))[0][0]
    np.testing.assert_allclose(np.asarray(taps[center]), np.asarray(img))


def test_bilinear_identity(img):
    ys = (jnp.arange(H) + 0.5) / H
    xs = (jnp.arange(W) + 0.5) / W
    yy, xx = jnp.meshgrid(ys, xs, indexing="ij")
    uv = jnp.stack([xx, yy], -1)
    out = bilinear_sample(img, uv)
    np.testing.assert_allclose(np.asarray(out), np.asarray(img), atol=1e-5)


def test_bicubic_identity(img):
    ys = (jnp.arange(H) + 0.5) / H
    xs = (jnp.arange(W) + 0.5) / W
    yy, xx = jnp.meshgrid(ys, xs, indexing="ij")
    uv = jnp.stack([xx, yy], -1)
    out = bicubic_catmull_rom_sample(img, uv)
    np.testing.assert_allclose(np.asarray(out), np.asarray(img), atol=1e-4)


def test_gaussian_weights_normalized():
    for r in (1, 2, 3):
        w = np.asarray(gaussian_weights(r))
        assert w.shape == ((2 * r + 1) ** 2,)
        np.testing.assert_allclose(w.sum(), 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# temporal / spatial denoise
# ---------------------------------------------------------------------------


def _gbuf(rng):
    color = jnp.asarray(rng.uniform(0, 1, (H, W, 3)).astype(np.float32))
    normal = jnp.tile(jnp.array([0.0, 1.0, 0.0], jnp.float32), (H, W, 1))
    depth = jnp.full((H, W), 5.0)
    mat = jnp.zeros((H, W), jnp.int32)
    motion = jnp.zeros((H, W, 2))
    return color, normal, depth, mat, motion


def test_temporal_accumulates_static_scene(rng):
    p = default_params().denoise
    color, normal, depth, mat, motion = _gbuf(rng)
    hist = color * 0.0 + 0.5
    out = temporal_filter(color, normal, depth, mat, motion, hist, depth, mat,
                          jnp.asarray(True), p)
    o = np.asarray(out)
    c = np.asarray(color)
    # output between history and current (blended), not equal to either
    assert not np.allclose(o, c)
    # variance reduced vs raw input
    assert o.std() < c.std()


def test_temporal_rejects_on_material_mismatch(rng):
    p = default_params().denoise
    color, normal, depth, mat, motion = _gbuf(rng)
    hist = color * 0.0 + 10.0  # wildly different history
    hist_mat = jnp.ones((H, W), jnp.int32)  # mismatched ids
    out = temporal_filter(color, normal, depth, mat, motion, hist, depth,
                          hist_mat, jnp.asarray(True), p)
    # invalid history => passthrough of current color
    np.testing.assert_allclose(np.asarray(out), np.asarray(color), atol=1e-5)


def test_tile_noise_level_flags_noise(rng):
    flat = jnp.ones((H, W, 3))
    noisy = jnp.asarray(rng.uniform(0, 1, (H, W, 3)).astype(np.float32))
    depth = jnp.full((H, W), 5.0)
    n_flat = np.asarray(tile_noise_level(flat, depth))
    n_noisy = np.asarray(tile_noise_level(noisy, depth))
    assert n_flat.max() < 1e-6
    assert n_noisy.mean() > 0.01
    assert tile_noise_downsample(tile_noise_level(noisy, depth)).shape == \
        (H // 16, W // 16)


@pytest.mark.slow
def test_spatial_filter_smooths_but_keeps_edges(rng):
    p = default_params().denoise._replace(noise_threshold=jnp.float32(1e-6))
    color, normal, depth, mat, motion = _gbuf(rng)
    # two material regions with different depth: an "edge"
    mat = mat.at[:, W // 2:].set(1)
    depth = depth.at[:, W // 2:].set(50.0)
    noise8 = tile_noise_level(color, depth)
    out = np.asarray(spatial_filter_7x7(color, normal, depth, mat, noise8, p))
    c = np.asarray(color)
    # smoothing within each region
    assert out[:, :W // 2 - 8].std() < c[:, :W // 2 - 8].std()
    # left region mean unchanged-ish (no bleed from right region values)
    np.testing.assert_allclose(out[:, :W // 2 - 8].mean(),
                               c[:, :W // 2 - 8].mean(), atol=0.02)


@pytest.mark.slow
def test_full_denoise_pipeline_runs(rng):
    p = default_params().denoise
    flags = FeatureFlags()
    color, normal, depth, mat, motion = _gbuf(rng)
    albedo = jnp.full((H, W, 3), 0.8)
    hist = init_history(H, W)
    out, hist2 = denoise(color, albedo, normal, depth, mat, motion, hist, p,
                         flags)
    assert out.shape == (H, W, 3)
    assert bool(hist2.valid)
    # second frame uses history
    out2, _ = denoise(color, albedo, normal, depth, mat, motion, hist2, p,
                      flags)
    assert np.isfinite(np.asarray(out2)).all()


# ---------------------------------------------------------------------------
# post-processing
# ---------------------------------------------------------------------------


def test_downsample_and_upscale(img):
    small = downsample4(img)
    assert small.shape == (H // 4, W // 4, 3)
    np.testing.assert_allclose(np.asarray(small).mean(),
                               np.asarray(img).mean(), atol=1e-3)
    up = upscale_catmull_rom(small, H, W)
    assert up.shape == (H, W, 3)


def test_histogram_sums_to_one(img):
    h = np.asarray(log_luminance_histogram(img))
    np.testing.assert_allclose(h.sum(), 1.0, atol=1e-5)


def test_auto_exposure_adapts():
    state = init_exposure_state()
    dark = jnp.full((8, 8, 3), 0.02)
    bright = jnp.full((8, 8, 3), 5.0)
    s_dark = auto_exposure(dark, state, jnp.float32(10.0), jnp.float32(1.0))
    s_bright = auto_exposure(bright, state, jnp.float32(10.0), jnp.float32(1.0))
    assert float(s_dark[0]) > float(s_bright[0])  # dark scene gets more gain


def test_tonemappers_monotone_and_bounded(rng):
    c = jnp.asarray(rng.uniform(0, 20, (128, 3)).astype(np.float32))
    for f in (reinhard_extended, aces_fitted, aces_approx, uncharted2):
        out = np.asarray(f(c))
        assert (out >= -1e-4).all() and (out <= 1.0 + 1e-4).all()
    for ti in range(4):
        out = np.asarray(tonemap(c, jnp.float32(ti)))
        assert (out >= 0).all() and (out <= 1).all()


def test_bloom_adds_energy_near_bright(img):
    spiked = img.at[H // 2, W // 2].set(jnp.array([50.0, 50.0, 50.0]))
    out = np.asarray(bloom(spiked, jnp.float32(1.0), jnp.float32(0.1)))
    base = np.asarray(spiked)
    # neighbors of the spike gained energy
    assert out[H // 2 + 2, W // 2 + 2].sum() > base[H // 2 + 2, W // 2 + 2].sum()


def test_lens_flare_gated_by_visibility():
    vis = np.asarray(lens_flare(H, W, jnp.array([0.5, 0.5]), jnp.float32(1.0),
                                jnp.float32(1.0)))
    hid = np.asarray(lens_flare(H, W, jnp.array([0.5, 0.5]), jnp.float32(0.0),
                                jnp.float32(1.0)))
    assert vis.sum() > 0 and hid.sum() == 0


def test_sharpen_median(img):
    out = np.asarray(sharpen(img, jnp.float32(0.5)))
    assert out.shape == (H, W, 3)
    med = np.asarray(median3(img))
    assert med.std() <= np.asarray(img).std()
