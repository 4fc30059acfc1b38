"""Multi-chip SPMD frame: the REAL render_frame sharded over a row mesh.

Validates the product multi-chip path (parallel/frame_spmd.py): the full
frame program — LBVH rebuild, wavefront path trace, temporal+spatial SVGF
with history carry, exposure/bloom/tonemap post — jitted over an 8-virtual-
CPU-device mesh, compared against the identical single-device program.
The partitioner's inserted collectives (stencil halos, histogram
all-reduce, reprojection gathers) must not change the image beyond
reduction-reassociation noise.
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

# slow tier: 8-device GSPMD compiles of the full frame program — fast CI tier runs `pytest -m "not slow"`
pytestmark = pytest.mark.slow

W, H = 96, 56  # H divisible by 8 row shards


@pytest.fixture(scope="module")
def spmd_setup(request):
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
    cam2 = make_camera(pos=(0.05, 3.0, -8.9), yaw=0.01, pitch=-0.15)
    args = (jnp.asarray(pad["indices"]), jnp.asarray(pad["tri_mat"]),
            jnp.asarray(pad["valid"]), scene.materials, textures, sky,
            scene.lights, state, cam, cam, default_params(),
            jnp.float32(1 / 60))
    return static, args, cam2


def _run_frames(fn, args, cam2, n_frames, put_state=None):
    """Run n frames threading state; frame 2+ moves the camera (exercises
    motion reprojection across shard boundaries)."""
    args = list(args)
    imgs = []
    for i in range(n_frames):
        if i == 1:
            args[9] = args[8]   # prev_camera <- camera
            args[8] = cam2      # camera moves
        img, new_state = fn(*args)
        if put_state is not None:
            new_state = put_state(new_state)
        args[7] = new_state
        imgs.append(np.asarray(img).astype(np.int32))
    return imgs


def test_spmd_frame_matches_single_device(spmd_setup, cpu_mesh_devices):
    """8-way row-sharded real frame == single-device frame (2 frames,
    second with camera motion), within u8 rounding of reduction noise."""
    from functools import partial

    from rtrt_tpu.parallel.frame_spmd import (make_row_mesh,
                                              make_spmd_frame_fn,
                                              replicate,
                                              shard_frame_state)

    static, args, cam2 = spmd_setup
    cpu0 = cpu_mesh_devices[0]

    # single-device reference on CPU device 0 (jit follows the inputs)
    ref_fn = jax.jit(partial(render_frame, static))
    ref_args = jax.device_put(args, cpu0)
    ref_imgs = _run_frames(ref_fn, ref_args, jax.device_put(cam2, cpu0), 2)

    mesh = make_row_mesh(8, devices=cpu_mesh_devices)
    spmd_fn = make_spmd_frame_fn(mesh, static)
    sh_args = list(replicate(mesh, args))
    sh_args[7] = shard_frame_state(mesh, args[7])
    got_imgs = _run_frames(spmd_fn, tuple(sh_args),
                           replicate(mesh, cam2), 2)

    for k, (a, b) in enumerate(zip(ref_imgs, got_imgs)):
        # identical math per pixel; collectives only reassociate the
        # exposure-histogram reduction -> at most ±1 u8 step
        diff = np.abs(a - b)
        assert diff.max() <= 1, (k, diff.max(), (diff > 1).mean())
        assert (diff > 0).mean() < 0.05, (k, (diff > 0).mean())


def test_spmd_history_stays_sharded(spmd_setup, cpu_mesh_devices):
    """The history carry must come back row-sharded (no silent gather of
    the persistent state between frames)."""
    from rtrt_tpu.parallel.frame_spmd import (AXIS, make_row_mesh,
                                              make_spmd_frame_fn,
                                              replicate,
                                              shard_frame_state)

    static, args, _ = spmd_setup
    mesh = make_row_mesh(8, devices=cpu_mesh_devices)
    spmd_fn = make_spmd_frame_fn(mesh, static)
    sh_args = list(replicate(mesh, args))
    sh_args[7] = shard_frame_state(mesh, args[7])
    img, new_state = spmd_fn(*sh_args)
    jax.block_until_ready(img)
    spec = new_state.history.color.sharding.spec
    assert spec and spec[0] == AXIS, spec


def test_sharded_refit_matches_replicated(cpu_mesh_devices):
    """The sharded-leaf-bounds refit (parallel/frame_spmd.py::sharded_refit)
    must produce the identical node table as the single-device refit —
    min/max reductions reassociate exactly."""
    from rtrt_tpu.bvh.refit import leaf_bounds, plan_refit4, refit_nodes4
    from rtrt_tpu.bvh.sah import build_scene_tables_sah, bvh4_nodes
    from rtrt_tpu.engine.scene import build_demo_scene, padded_arrays
    from rtrt_tpu.parallel.frame_spmd import make_row_mesh, sharded_refit

    scene = build_demo_scene()
    pad = padded_arrays(scene)
    bvh, nrm_t, mat_s = build_scene_tables_sah(
        scene.num_batches, jnp.asarray(pad["indices"]),
        jnp.asarray(pad["tri_mat"]), jnp.asarray(pad["valid"]),
        jnp.asarray(scene.vertices), jnp.asarray(scene.normals),
        leaf_max=8)
    raw4 = bvh4_nodes(bvh)
    plan = plan_refit4(raw4, leaf_width=8)
    n_leaves = plan.n_leaves if hasattr(plan, "n_leaves") else \
        int(bvh.tris_t.shape[1]) // 8
    # pad leaves to the mesh size
    mesh = make_row_mesh(8, devices=cpu_mesh_devices)
    n_pad = -(-n_leaves // 8) * 8
    tt = jnp.pad(bvh.tris_t, ((0, 0), (0, (n_pad - n_leaves) * 8)),
                 mode="edge")

    lo, hi = leaf_bounds(tt, n_pad, 8)
    want = refit_nodes4(plan, lo[:n_leaves], hi[:n_leaves])

    with mesh:
        got = jax.jit(lambda t: sharded_refit(
            mesh, plan, t, n_pad, 8)[:, :])(tt)
    # plan indexes only real leaves, so padded bounds never contribute
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=0)
