"""Multi-chip tile-parallel rendering over a jax.sharding.Mesh.

The reference is strictly single-GPU; its only cross-domain transport is
CUDA<->Vulkan interop (SURVEY.md §2.8/§5.8).  Here the scaling story is
SPMD tile parallelism: the image's ROW dimension shards
across chips (`shard_map` over a 1-D mesh), the scene/BVH replicate, and the
only cross-chip dependencies ride collectives:

  * auto-exposure needs the GLOBAL luminance histogram -> `psum`;
  * denoise spatial stencils need row halos at shard boundaries -> halo
    exchange via `ppermute` with up-/down-neighbors;
  * the presented frame is gathered on host (or kept sharded for encoding).

This module provides `make_tile_frame(mesh, ...)`: a jitted SPMD frame step
running raygen -> path trace -> temporal+spatial denoise (halo-exchanged)
-> global exposure -> tonemap for each row shard.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..core.camera import Camera, camera_basis
from ..core.vecmath import normalize
from ..denoise.spatial import spatial_filter_7x7
from ..denoise.temporal import tile_noise_level
from ..post.exposure import (LOG_LUM_MAX, LOG_LUM_MIN, NUM_BINS,
                             exposure_compensation)
from ..post.tonemap import tonemap
from ..render.integrator import SceneData, path_trace
from ..render.raygen import generate_rays
from ..render.sampling import rand2
from ..utils.config import DenoiseParams

AXIS = "rows"


def _halo_exchange(img, halo: int, axis_name: str):
    """Exchange `halo` boundary rows with mesh neighbors and concatenate:
    (Hs, W, C) -> (halo + Hs + halo, W, C).  Edge shards clamp-pad."""
    n = jax.lax.psum(1, axis_name)
    idx = jax.lax.axis_index(axis_name)
    up = [(i, (i - 1) % n) for i in range(n)]     # send my top rows upward
    down = [(i, (i + 1) % n) for i in range(n)]   # send my bottom rows down

    top_rows = img[:halo]
    bot_rows = img[-halo:]
    from_below = jax.lax.ppermute(top_rows, axis_name, up)    # my lower halo
    from_above = jax.lax.ppermute(bot_rows, axis_name, down)  # my upper halo

    # clamp at the global image edges (wrap-around neighbors are invalid)
    first = idx == 0
    last = idx == n - 1
    from_above = jnp.where(first, jnp.broadcast_to(img[:1], from_above.shape),
                           from_above)
    from_below = jnp.where(last, jnp.broadcast_to(img[-1:], from_below.shape),
                           from_below)
    return jnp.concatenate([from_above, img, from_below], axis=0)


def _global_histogram(lum_shard, axis_name):
    """Per-shard log-luminance histogram summed across chips (the atomic-free
    + NCCL-free analog of the reference's atomicInc histogram)."""
    ll = jnp.clip((jnp.log2(jnp.maximum(lum_shard.reshape(-1), 1e-8))
                   - LOG_LUM_MIN) / (LOG_LUM_MAX - LOG_LUM_MIN), 0.0, 1.0)
    b = (ll * (NUM_BINS - 1)).astype(jnp.int32)
    onehot = (b[:, None] == jnp.arange(NUM_BINS)[None, :]).astype(jnp.float32)
    hist = jnp.sum(onehot, axis=0)
    return jax.lax.psum(hist, axis_name)


def make_tile_frame(mesh: Mesh, scene_data_builder, width: int, height: int,
                    denoise_params: DenoiseParams, trace: str = "xla"):
    """Build the SPMD frame step.

    scene_data_builder: callable (vertices) -> SceneData, traced inside jit
      (BVH rebuild replicates — every chip builds the same tree; sharding
      the build itself is a later optimization).
    Returns a jitted fn(vertices, camera, prev_camera, hist_color_sharded,
      frame_idx) -> (image_sharded (H, W, 3) u8, new_hist (H, W, 3)).
    """
    n = mesh.devices.size
    assert height % n == 0, (height, n)
    hs = height // n

    def shard_body(scene: SceneData, camera: Camera, prev_camera: Camera,
                   hist_color, frame_idx):
        row0 = jax.lax.axis_index(AXIS) * hs
        basis = camera_basis(camera)
        aspect = width / height

        # raygen for this shard's pixel rows (global uv coordinates)
        ys = (jnp.arange(hs, dtype=jnp.float32)[:, None] + row0)
        xs = jnp.arange(width, dtype=jnp.float32)[None, :]
        pix_ids = ((ys.astype(jnp.int32) * width)
                   + xs.astype(jnp.int32)).reshape(-1)
        jitter = rand2(pix_ids, frame_idx, jnp.uint32(0))
        uv = jnp.stack([
            jnp.broadcast_to(xs, (hs, width)).reshape(-1),
            jnp.broadcast_to(ys, (hs, width)).reshape(-1)], axis=-1)
        uv = (uv + jitter) / jnp.array([width, height], jnp.float32)
        from ..core.camera import pixel_to_dir
        d = pixel_to_dir(basis, uv, aspect)
        from ..render.raygen import Rays
        rays = Rays(jnp.broadcast_to(basis.pos, d.shape), d, uv,
                    jnp.full(d.shape[:-1],
                             2.0 * basis.tan_half_fov_y / height))

        prev_basis = camera_basis(prev_camera)
        gbuf = path_trace(scene, rays, pix_ids, frame_idx, prev_basis,
                          aspect, trace=trace)

        color = (gbuf.color * gbuf.albedo).reshape(hs, width, 3)
        normal = gbuf.normal.reshape(hs, width, 3)
        depth = gbuf.depth.reshape(hs, width)
        mat_id = gbuf.mat_id.reshape(hs, width)

        # temporal blend against the sharded history (static camera terms)
        blend = jnp.float32(0.2)
        color = color * blend + hist_color * (1.0 - blend)
        new_hist = color

        # spatial denoise with a halo exchange for the stencil borders
        halo = 4
        c_h = _halo_exchange(color, halo, AXIS)
        n_h = _halo_exchange(normal, halo, AXIS)
        d_h = _halo_exchange(depth[..., None], halo, AXIS)[..., 0]
        m_h = _halo_exchange(mat_id[..., None].astype(jnp.float32), halo,
                             AXIS)[..., 0].astype(jnp.int32)
        noise8 = tile_noise_level(c_h, d_h, 8)
        filtered = spatial_filter_7x7(c_h, n_h, d_h, m_h, noise8,
                                      denoise_params)
        color = filtered[halo:-halo]

        # global auto-exposure across all shards (psum histogram)
        lum = jnp.sum(color * jnp.array([0.2126, 0.7152, 0.0722]), axis=-1)
        hist = _global_histogram(lum, AXIS)
        cdf = jnp.cumsum(hist) / jnp.maximum(jnp.sum(hist), 1.0)
        centers = LOG_LUM_MIN + (jnp.arange(NUM_BINS) + 0.5) / NUM_BINS \
            * (LOG_LUM_MAX - LOG_LUM_MIN)
        prev = cdf - hist / jnp.maximum(jnp.sum(hist), 1.0)
        clipped = jnp.clip(jnp.minimum(cdf, 0.9) - jnp.maximum(prev, 0.4),
                           0.0, None)
        mean_ll = jnp.sum(clipped * centers) / jnp.maximum(jnp.sum(clipped),
                                                           1e-6)
        avg_lum = 2.0 ** mean_ll
        ev = exposure_compensation(avg_lum) / jnp.maximum(avg_lum, 1e-6)

        ldr = tonemap(color * ev, jnp.float32(1.0))
        u8 = jnp.clip(ldr * 255.0 + 0.5, 0, 255).astype(jnp.uint8)
        return u8, new_hist

    rep = P()
    shd = P(AXIS)
    body = shard_map(
        shard_body, mesh=mesh,
        in_specs=(rep, rep, rep, shd, rep),
        out_specs=(shd, shd),
        check_vma=False)

    def frame(vertices, camera, prev_camera, hist_color, frame_idx):
        scene = scene_data_builder(vertices)
        return body(scene, camera, prev_camera, hist_color, frame_idx)

    return jax.jit(frame)
