"""Component-form bounce program == wavefront integrator:
`simulate_megakernel` (render/megakernel.py, the shading program over
per-component arrays, under plain XLA with the wavefront traverser) vs
`integrator.path_trace` — validates the component-form port of the whole
bounce program on CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtrt_tpu.bvh.build import build_scene_bvh
from rtrt_tpu.bvh.types import BATCH_SIZE
from rtrt_tpu.core.camera import camera_basis, make_camera
from rtrt_tpu.engine.scene import build_demo_scene, padded_arrays
from rtrt_tpu.render.integrator import SceneData, path_trace
from rtrt_tpu.render.megakernel import finish_gbuffer, simulate_megakernel
from rtrt_tpu.render.raygen import generate_rays_padded
from rtrt_tpu.render.sampling import rand2
from rtrt_tpu.render.sky import (bake_sky_maps, finalize_sky_maps,
                                 make_sky_params)
from rtrt_tpu.render.texture import make_soil_textures

# slow tier: every test compiles the full bounce program — minutes each on
# a CPU host.
pytestmark = pytest.mark.slow

W, H = 64, 32


def build_setup():
    host = build_demo_scene()
    pad = padded_arrays(host)
    indices = jnp.asarray(pad["indices"])
    valid = jnp.asarray(pad["valid"])
    verts = jnp.asarray(host.vertices)
    nrm = jnp.asarray(host.normals)
    b = host.num_batches
    tv0 = verts[indices[:, 0]].reshape(b, BATCH_SIZE, 3)
    tv1 = verts[indices[:, 1]].reshape(b, BATCH_SIZE, 3)
    tv2 = verts[indices[:, 2]].reshape(b, BATCH_SIZE, 3)
    bvh = jax.jit(build_scene_bvh)(tv0, tv1, tv2, valid)
    sort_idx = bvh.sorted_tri_index
    flat_idx = indices[sort_idx]
    tri_nrm_t = jnp.concatenate(
        [nrm[flat_idx[:, 0]].T, nrm[flat_idx[:, 1]].T,
         nrm[flat_idx[:, 2]].T], axis=0)
    sky = finalize_sky_maps(jax.jit(lambda p: bake_sky_maps(
        p, sky_res=(16, 32), sun_res=(4, 4)))(make_sky_params()))
    scene = SceneData(bvh=bvh, tri_nrm_t=tri_nrm_t,
                      tri_mat=jnp.asarray(pad["tri_mat"])[sort_idx],
                      materials=host.materials, sky=sky,
                      textures=make_soil_textures(16), lights=host.lights)

    cam = make_camera(pos=(0.0, 3.0, -9.0), pitch=-0.15)
    basis = camera_basis(cam)
    n_pix = W * H
    pixel_ids = jnp.arange(n_pix, dtype=jnp.int32)
    frame = jnp.uint32(3)
    jitter = rand2(pixel_ids, frame, jnp.uint32(0))
    lens = rand2(pixel_ids, frame, jnp.uint32(256))
    rays = generate_rays_padded(basis, W, H, pixel_ids, jitter, lens)
    return scene, rays, pixel_ids, frame, basis


@pytest.fixture(scope="module")
def setup():
    return build_setup()


def _gbuffers_close(ref, got, atol=5e-3, frac=0.98):
    """Compare G-buffers allowing (a) ~0.3% relative noise — the sun-disk
    limb-darkening term amplifies 1-ulp cos differences ~2000x at the disk
    edge (sin^2_max ~ 2e-5), which feeds NEE radiance — and (b) a small
    fraction of pixels whose stochastic MIS branch flips at a float decision
    boundary and diverges completely."""
    for name in ("color", "albedo", "normal", "motion"):
        a = np.asarray(getattr(ref, name))
        g = np.asarray(getattr(got, name))
        fin = np.isfinite(a)
        ok = np.isclose(a, g, rtol=5e-3, atol=atol) | ~fin
        assert ok.mean() >= frac, f"{name}: only {ok.mean():.4f} match"
        # energy-level agreement: branch flips must stay unbiased
        err = np.abs(np.where(fin, a - g, 0.0))
        scale = max(np.abs(np.where(fin, a, 0.0)).mean(), 1e-3)
        assert err.mean() / scale < 0.01, \
            f"{name}: mean rel err {err.mean() / scale:.4f}"
    d_a = np.asarray(ref.depth)
    d_g = np.asarray(got.depth)
    both_inf = ~np.isfinite(d_a) & ~np.isfinite(d_g)
    ok = both_inf | np.isclose(d_a, d_g, rtol=1e-4, atol=1e-4)
    assert ok.mean() >= frac, f"depth: only {ok.mean():.4f} match"
    m_ok = np.asarray(ref.mat_id) == np.asarray(got.mat_id)
    assert m_ok.mean() >= frac


def test_simulator_matches_integrator(setup):
    scene, rays, pixel_ids, frame, basis = setup
    ref = jax.jit(lambda: path_trace(
        scene, rays, pixel_ids, frame, basis, W / H, max_steps=512))()
    out = jax.jit(lambda: simulate_megakernel(
        scene, rays, pixel_ids, frame, max_steps=512))()
    got = finish_gbuffer(scene, rays, out, basis, W / H)
    _gbuffers_close(ref, got)
