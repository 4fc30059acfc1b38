"""Tests: sampling, BSDFs, sky/light, procedural textures."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtrt_tpu.core.vecmath import dot, normalize
from rtrt_tpu.render import sampling as smp
from rtrt_tpu.render import bsdf as B
from rtrt_tpu.render.proctex import soil_shading, value_noise3
from rtrt_tpu.render.sky import (bake_sky_maps, build_alias_table,
                                 dir_to_equal_area_uv, equal_area_uv_to_dir,
                                 env_radiance_analytic, finalize_sky_maps,
                                 make_sky_params)
from rtrt_tpu.render.light import env_light_pdf, sample_env_light


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def test_sobol_owen_uniform():
    """First two moments of the scrambled sequence match U[0,1)."""
    idx = jnp.arange(1024, dtype=jnp.uint32)
    pts = np.asarray(smp.sobol_owen_2d(idx, jnp.uint32(12345)))
    assert pts.shape == (1024, 2)
    assert (pts >= 0).all() and (pts < 1).all()
    np.testing.assert_allclose(pts.mean(0), 0.5, atol=0.02)
    np.testing.assert_allclose(pts.var(0), 1 / 12, atol=0.01)


def test_sobol_stratification_beats_white():
    """LD points must cover strata better than white noise."""
    idx = jnp.arange(256, dtype=jnp.uint32)
    ld = np.asarray(smp.sobol_owen_2d(idx, jnp.uint32(7)))
    # count occupied cells of a 16x16 grid — LD should fill all 256
    cells = set(map(tuple, (ld * 16).astype(int)))
    assert len(cells) >= 230  # white noise averages ~162


def test_rand2_decorrelated_across_pixels():
    f = jnp.uint32(3)
    a = np.asarray(smp.rand2(jnp.uint32(100), f, jnp.uint32(0)))
    b = np.asarray(smp.rand2(jnp.uint32(101), f, jnp.uint32(0)))
    assert not np.allclose(a, b)


def test_concentric_disk_in_unit_disk(rng):
    u = jnp.asarray(rng.uniform(0, 1, (512, 2)).astype(np.float32))
    d = np.asarray(smp.concentric_disk(u))
    assert (np.linalg.norm(d, axis=-1) <= 1.0 + 1e-6).all()


def test_cosine_hemisphere_distribution(rng):
    u = jnp.asarray(rng.uniform(0, 1, (8192, 2)).astype(np.float32))
    d = np.asarray(smp.cosine_hemisphere(u))
    assert (d[:, 2] >= -1e-6).all()
    # E[cos] for pdf cos/pi is 2/3
    np.testing.assert_allclose(d[:, 2].mean(), 2 / 3, atol=0.02)


def test_power_heuristic_limits():
    assert float(smp.power_heuristic(1.0, 1.0, 1.0, 0.0)) == 1.0
    assert abs(float(smp.power_heuristic(1.0, 1.0, 1.0, 1.0)) - 0.5) < 1e-6
    assert float(smp.power_heuristic(1.0, 0.0, 1.0, 0.0)) == 0.0


# ---------------------------------------------------------------------------
# BSDFs
# ---------------------------------------------------------------------------


def _up_normals(n):
    return jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (n, 1))


def test_lambert_white_furnace(rng):
    """Integral of f*cos over hemisphere == albedo (energy conservation)."""
    n = 8192
    nrm = _up_normals(n)
    wo = normalize(jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
                   * jnp.array([1, 1, 0]) + jnp.array([0, 0, 1.0]))
    u = jnp.asarray(rng.uniform(0, 1, (n, 2)).astype(np.float32))
    mtype = jnp.zeros((n,), jnp.int32)
    alb = jnp.full((n, 3), 0.7)
    bs = B.sample_bsdf(mtype, alb, jnp.full((n,), 0.5), jnp.full((n,), 1.5),
                       jnp.full((n, 3), 0.04), nrm, wo,
                       jnp.zeros((n,), bool), u)
    # weight = f cos / pdf; E[weight] = albedo for cosine sampling
    np.testing.assert_allclose(np.asarray(bs.weight).mean(0), 0.7, atol=0.01)
    assert not bool(bs.is_delta[0])


def test_mirror_reflects():
    nrm = _up_normals(1)
    wo = normalize(jnp.array([[0.5, 0.0, 0.8]]))
    bs = B.sample_bsdf(jnp.array([B.MAT_MIRROR]), jnp.ones((1, 3)),
                       jnp.zeros((1,)), jnp.ones((1,)), jnp.ones((1, 3)),
                       nrm, wo, jnp.zeros((1,), bool),
                       jnp.full((1, 2), 0.3))
    wi = np.asarray(bs.wi)[0]
    woh = np.asarray(wo)[0]
    assert abs(wi[2] - woh[2]) < 1e-5 and abs(wi[0] + woh[0]) < 1e-5
    assert bool(bs.is_delta[0])


def test_glass_energy_split(rng):
    """Across many stochastic samples, reflect+refract both occur and
    direction is consistent with Snell for refraction."""
    n = 4096
    nrm = _up_normals(n)
    wo = jnp.tile(normalize(jnp.array([[0.3, 0.0, 0.95]])), (n, 1))
    u = jnp.asarray(rng.uniform(0, 1, (n, 2)).astype(np.float32))
    bs = B.sample_bsdf(jnp.full((n,), B.MAT_GLASS), jnp.ones((n, 3)),
                       jnp.zeros((n,)), jnp.full((n,), 1.5), jnp.ones((n, 3)),
                       nrm, wo, jnp.zeros((n,), bool), u)
    wi = np.asarray(bs.wi)
    refl = wi[:, 2] > 0
    refr = wi[:, 2] < 0
    assert refl.any() and refr.any()
    frac_refl = refl.mean()
    assert 0.01 < frac_refl < 0.3  # near-normal incidence: mostly transmits


@pytest.mark.slow
def test_ggx_eval_pdf_consistency(rng):
    """Monte-Carlo: sampling with the GGX sampler and dividing by its pdf
    integrates D*G*F*cos to ~the same value as uniform-hemisphere MC."""
    n = 16384
    nrm = _up_normals(n)
    wo = jnp.tile(normalize(jnp.array([[0.4, 0.0, 0.9]])), (n, 1))
    alb = jnp.ones((n, 3))
    f0 = jnp.full((n, 3), 1.0)
    rough = jnp.full((n,), 0.5)
    u = jnp.asarray(rng.uniform(0, 1, (n, 2)).astype(np.float32))
    # uniform-hemisphere estimate
    wi_u = smp.uniform_hemisphere(u)
    f_u, _ = B.eval_bsdf(jnp.full((n,), B.MAT_GGX), alb, rough, f0, nrm, wo, wi_u)
    cos_u = jnp.maximum(wi_u[:, 2], 0.0)
    est_u = np.asarray(f_u[:, 0] * cos_u).mean() * 2 * np.pi
    # importance-sampled estimate
    bs = B.sample_bsdf(jnp.full((n,), B.MAT_GGX), alb, rough,
                       jnp.full((n,), 1.5), f0, nrm, wo,
                       jnp.zeros((n,), bool), u)
    est_s = np.asarray(bs.weight[:, 0]).mean()
    np.testing.assert_allclose(est_u, est_s, rtol=0.1)


def test_fresnel_dielectric_limits():
    # normal incidence on glass: ~4%
    f = float(B.fresnel_dielectric(jnp.asarray(1.0), jnp.asarray(1.5)))
    assert abs(f - 0.04) < 0.005
    # grazing: ~1
    f = float(B.fresnel_dielectric(jnp.asarray(0.01), jnp.asarray(1.5)))
    assert f > 0.9


def test_material_lookup_matches_gather(rng):
    mats = B.make_materials([
        dict(mtype=B.MAT_LAMBERT, albedo=(0.5, 0.4, 0.3)),
        dict(mtype=B.MAT_GGX, albedo=(0.9, 0.7, 0.3), roughness=0.25),
        dict(mtype=B.MAT_GLASS, ior=1.33),
    ])
    ids = jnp.asarray(rng.integers(0, 3, 64).astype(np.int32))
    mtype, alb, rough, ior, f0, emission, tex = B.material_lookup(mats, ids)
    np.testing.assert_array_equal(np.asarray(mtype), np.asarray(mats.mtype)[np.asarray(ids)])
    np.testing.assert_allclose(np.asarray(alb), np.asarray(mats.albedo)[np.asarray(ids)])
    np.testing.assert_allclose(np.asarray(ior), np.asarray(mats.ior)[np.asarray(ids)])


# ---------------------------------------------------------------------------
# sky + env light
# ---------------------------------------------------------------------------


def test_equal_area_roundtrip(rng):
    d = normalize(jnp.asarray(rng.normal(size=(256, 3)).astype(np.float32)))
    d2 = equal_area_uv_to_dir(dir_to_equal_area_uv(d))
    np.testing.assert_allclose(np.asarray(d2), np.asarray(d), atol=1e-5)


@pytest.fixture(scope="module")
def sky_maps():
    params = make_sky_params(sun_elevation=0.6)
    return finalize_sky_maps(jax.jit(
        lambda p: bake_sky_maps(p, sky_res=(32, 64), sun_res=(8, 8)))(params))


def test_sky_physical_shape(sky_maps):
    m = np.asarray(sky_maps.sky_map)
    assert (m >= 0).all() and np.isfinite(m).all()
    h = m.shape[0]
    up = m[int(h * 0.9)].mean(axis=(0,))      # high elevation rows
    horizon = m[int(h * 0.55)].mean(axis=(0,))
    # sky is blue: B channel dominates up high
    assert up[2] > up[0]
    # horizon is brighter than zenith (path length)
    assert horizon.sum() > up.sum() * 0.8


def test_alias_table_distribution(rng):
    w = rng.uniform(0, 1, 64) ** 3
    p, a = build_alias_table(w)
    # Monte-Carlo the alias sampler and compare against the target dist
    u1 = rng.uniform(0, 1, 200000)
    u2 = rng.uniform(0, 1, 200000)
    k = np.minimum((u1 * 64).astype(int), 63)
    pick = np.where(u2 < p[k], k, a[k])
    counts = np.bincount(pick, minlength=64) / pick.size
    np.testing.assert_allclose(counts, w / w.sum(), atol=0.004)


def test_env_sampling_pdf_consistency(sky_maps, rng):
    """sample_env_light's reported pdf must match env_light_pdf at the
    sampled direction (up to texel discretization)."""
    n = 2048
    u3 = jnp.asarray(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    ls = sample_env_light(sky_maps, u3)
    pdf2 = env_light_pdf(sky_maps, ls.wi)
    a = np.asarray(ls.pdf)
    b = np.asarray(pdf2)
    ok = np.isclose(a, b, rtol=0.35, atol=1e-5)
    assert ok.mean() > 0.9  # texel-edge jitter mismatches allowed


def test_env_analytic_matches_map(sky_maps, rng):
    """The analytic escaped-ray radiance must agree with the baked map
    (same atmosphere model) away from the sun/horizon."""
    from rtrt_tpu.render.sky import sky_radiance
    d = normalize(jnp.asarray(rng.normal(size=(128, 3)).astype(np.float32))
                  + jnp.array([0, 1.5, 0]))
    ana = np.asarray(env_radiance_analytic(sky_maps, d))
    mapped = np.asarray(sky_radiance(sky_maps, d))
    ratio = (ana + 1e-4) / (mapped + 1e-4)
    assert np.median(ratio) == pytest.approx(1.0, abs=0.25)


# ---------------------------------------------------------------------------
# procedural texture
# ---------------------------------------------------------------------------


def test_value_noise_range_and_determinism(rng):
    p = jnp.asarray(rng.uniform(-10, 10, (512, 3)).astype(np.float32))
    n1 = np.asarray(value_noise3(p, 7))
    n2 = np.asarray(value_noise3(p, 7))
    assert (n1 >= 0).all() and (n1 <= 1).all()
    np.testing.assert_array_equal(n1, n2)
    assert n1.std() > 0.05  # not constant


def test_soil_shading_outputs(rng):
    pos = jnp.asarray(rng.uniform(-20, 20, (256, 3)).astype(np.float32))
    ns = normalize(jnp.asarray(rng.normal(size=(256, 3)).astype(np.float32)))
    cone = jnp.full((256,), 0.01)
    alb, rough, n2 = soil_shading(pos, ns, cone)
    a = np.asarray(alb)
    assert (a >= 0).all() and (a <= 1).all()
    r = np.asarray(rough)
    assert (r >= 0.05).all() and (r <= 1.0).all()
    np.testing.assert_allclose(np.linalg.norm(np.asarray(n2), axis=-1), 1.0,
                               atol=1e-5)


def test_soil_lod_fades_detail():
    """Large cone widths must converge to the noise mean (analytic mip)."""
    pos = jnp.asarray(np.random.default_rng(0).uniform(-20, 20, (512, 3)).astype(np.float32))
    ns = jnp.tile(jnp.array([[0.0, 1.0, 0.0]]), (512, 1))
    alb_fine, _, _ = soil_shading(pos, ns, jnp.full((512,), 1e-4))
    alb_coarse, _, _ = soil_shading(pos, ns, jnp.full((512,), 100.0))
    # spatial variation per channel (not between-channel color variance)
    fine_std = np.asarray(alb_fine).std(axis=0).mean()
    coarse_std = np.asarray(alb_coarse).std(axis=0).mean()
    assert coarse_std < fine_std * 0.1


# ---------------------------------------------------------------------------
# local lights + emissive + animation
# ---------------------------------------------------------------------------


def test_sphere_light_sampling_hits_sphere(rng):
    from rtrt_tpu.render.light import SphereLights, sample_sphere_light
    lights = SphereLights(center=jnp.array([[0.0, 5.0, 0.0]]),
                          radius=jnp.array([1.0]),
                          emission=jnp.array([[10.0, 10.0, 10.0]]))
    p = jnp.asarray(rng.uniform(-2, 2, (256, 3)).astype(np.float32))
    u = jnp.asarray(rng.uniform(0, 1, (256, 2)).astype(np.float32))
    ls = sample_sphere_light(lights, jnp.zeros((256,), jnp.int32), p, u)
    # every sampled ray intersects the light sphere
    from rtrt_tpu.core.geometry import ray_sphere
    hit, t = ray_sphere(p, ls.wi, jnp.array([0.0, 5.0, 0.0]), jnp.asarray(1.0))
    assert np.asarray(hit).mean() > 0.98
    assert (np.asarray(ls.pdf) > 0).all()


def test_material_lookup_emission():
    mats = B.make_materials([
        dict(mtype=B.MAT_LAMBERT),
        dict(mtype=B.MAT_EMISSIVE, emission=(5.0, 4.0, 3.0)),
    ])
    out = B.material_lookup(mats, jnp.array([0, 1]))
    emission = out[5]
    np.testing.assert_allclose(np.asarray(emission),
                               [[0, 0, 0], [5, 4, 3]], atol=1e-6)


def test_wave_displacement():
    from rtrt_tpu.engine.frame import displace_wave
    v = jnp.zeros((64, 3))
    v1 = displace_wave(v, jnp.float32(0.3))
    v2 = displace_wave(v, jnp.float32(0.9))
    assert not np.allclose(np.asarray(v1), np.asarray(v2))
    # only y moves
    np.testing.assert_array_equal(np.asarray(v1)[:, 0], 0)
    np.testing.assert_array_equal(np.asarray(v1)[:, 2], 0)
    assert np.abs(np.asarray(v1)[:, 1]).max() <= 0.36


@pytest.mark.slow
def test_env_fit_matches_analytic():
    """The Chebyshev environment fit (production escape-path eval) must
    track the analytic raymarch oracle to sub-percent mean relative error
    (render/sky.py::env_radiance_fit)."""
    import jax
    from rtrt_tpu.render.sky import env_radiance_fit, sun_disk_radiance

    maps = finalize_sky_maps(jax.jit(bake_sky_maps)(make_sky_params()))
    rng = np.random.default_rng(3)
    d = rng.normal(size=(8192, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = jnp.asarray(d)
    fit = np.asarray(env_radiance_fit(maps, d))
    ana = np.asarray(env_radiance_analytic(maps, d))
    sun = np.asarray(sun_disk_radiance(maps, d))
    fit_sky = fit - sun
    ana_sky = ana - sun
    lum = ana_sky.mean(-1)
    rel = np.abs(fit_sky - ana_sky).mean(-1) / np.maximum(
        lum, lum.mean() * 0.05)
    assert rel.mean() < 0.01, rel.mean()
    assert np.percentile(rel, 95) < 0.03
    assert fit_sky.min() > -1e-3  # clamped non-negative


@pytest.mark.slow
def test_env_radiance_scene_ocean_and_stars(sky_maps):
    """Composed environment (render/environment.py — the active twin of the
    reference's dormant sky2 -> star -> water chain, sky2.cuh:75):
    downward rays hit the ocean (shade != sky, finite Fresnel blend);
    upward rays keep the plain sky; stars add energy only at night."""
    import jax
    from rtrt_tpu.render.environment import env_radiance_scene
    from rtrt_tpu.render.sky import env_radiance_fit, make_sky_params

    n = 256
    rng = np.random.default_rng(11)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = jnp.asarray(d)
    org = jnp.broadcast_to(jnp.asarray([0.0, 5.0, 0.0], jnp.float32), (n, 3))
    t = jnp.float32(0.3)

    plain = np.asarray(env_radiance_fit(sky_maps, d))
    both = np.asarray(jax.jit(lambda o, dd: env_radiance_scene(
        sky_maps, o, dd, t, ocean=True, stars=True))(org, d))
    dn = np.asarray(d)
    down = dn[:, 1] < -0.05
    up = dn[:, 1] > 0.05
    assert np.isfinite(both).all() and (both >= 0).all()
    # ocean replaces the below-horizon environment for downward rays
    assert np.abs(both[down] - plain[down]).max() > 1e-3
    # daytime sun (fixture elevation 0.6): stars invisible, sky unchanged
    np.testing.assert_allclose(both[up], plain[up], rtol=1e-5, atol=1e-6)

    # night sky: stars contribute above the horizon.  Star cores are tiny
    # (a few arcmin), so sample densely to land on some.
    night = finalize_sky_maps(jax.jit(lambda p: bake_sky_maps(
        p, sky_res=(32, 64), sun_res=(8, 8)))(
            make_sky_params(sun_elevation=-0.4)))
    nb = 32768
    db = rng.normal(size=(nb, 3)).astype(np.float32)
    db /= np.linalg.norm(db, axis=-1, keepdims=True)
    db = jnp.asarray(db)
    ob = jnp.broadcast_to(org[0], (nb, 3))
    plain_n = np.asarray(env_radiance_fit(night, db))
    starred = np.asarray(jax.jit(lambda o, dd: env_radiance_scene(
        night, o, dd, t, stars=True))(ob, db))
    added = (starred - plain_n).max(-1)
    dbn = np.asarray(db)
    assert (added[dbn[:, 1] > 0.05] > 1e-4).any(), "no stars at night"
    assert np.abs(added[dbn[:, 1] < -0.05]).max() < 1e-6, \
        "stars below the horizon"


@pytest.mark.slow
def test_frame_with_ocean_and_stars_flags():
    """Full frame program with the ocean+stars flags on (CPU wavefront
    path): compiles, runs, stays finite — the engine-level wiring of
    render/environment.py through engine/frame.py."""
    from functools import partial

    from rtrt_tpu.core.camera import make_camera
    from rtrt_tpu.denoise.pipeline import init_history
    from rtrt_tpu.engine.frame import FrameState, FrameStatic, render_frame
    from rtrt_tpu.engine.scene import build_demo_scene, padded_arrays
    from rtrt_tpu.post.exposure import init_exposure_state
    from rtrt_tpu.render.texture import make_soil_textures
    from rtrt_tpu.utils.config import FeatureFlags, default_params

    W, H = 64, 32
    scene = build_demo_scene()
    pad = padded_arrays(scene)
    flags = FeatureFlags(ocean=True, stars=True, postprocess=False)
    static = FrameStatic(render_w=W, render_h=H, screen_w=W, screen_h=H,
                         num_batches=scene.num_batches, flags=flags)
    sky = finalize_sky_maps(jax.jit(lambda p: bake_sky_maps(
        p, sky_res=(32, 64), sun_res=(8, 8)))(make_sky_params()))
    tex = make_soil_textures(16)
    state = FrameState(vertices=jnp.asarray(scene.vertices),
                       normals=jnp.asarray(scene.normals),
                       history=init_history(H, W),
                       exposure=init_exposure_state(),
                       frame_idx=jnp.uint32(0), time=jnp.float32(0.0))
    cam = make_camera(pos=(0.0, 3.0, -9.0), pitch=-0.15)
    fn = jax.jit(partial(render_frame, static))
    img, st2 = fn(jnp.asarray(pad["indices"]), jnp.asarray(pad["tri_mat"]),
                  jnp.asarray(pad["valid"]), scene.materials, tex, sky,
                  scene.lights, state, cam, cam, default_params(),
                  jnp.float32(1 / 60))
    a = np.asarray(img)
    assert a.shape == (H, W, 3) and a.dtype == np.uint8
    assert np.isfinite(np.asarray(st2.history.color,
                                  dtype=np.float32)).all()
