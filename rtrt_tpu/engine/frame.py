"""The fused per-frame program: BVH rebuild -> path trace -> denoise -> post.

Counterpart of the reference's RayTracer::draw
(reference: src/kernel.cu:259-398) with one architectural difference: the
reference serializes ~30 kernel launches with a
cudaDeviceSynchronize between every stage (kernel.cu:282-396); here the
ENTIRE frame — two-level LBVH rebuild, path trace, SVGF chain,
postprocess, quantize — is a single jitted XLA program (on the GPU the BVH
traversal inside it is a Pallas kernel, bvh/lane_traverse.py).  No host round
trips, no per-stage sync, full compiler fusion across stage boundaries.

`make_frame_fn` closes over the static scene shape/flags and returns a
jit-compiled callable; dynamic resolution buckets each get their own
compiled executable (reference: dynamic resolution at kernel.cu:78-114;
static-shape strategy per SURVEY.md §7 stage 4).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..bvh.build import build_scene_bvh
from ..bvh.types import BATCH_SIZE
from ..core.camera import Camera, camera_basis, world_to_screen
from ..denoise.pipeline import DenoiseHistory, denoise
from ..ops.reduce import segment_sum
from ..post.pipeline import postprocess
from ..render.integrator import GBuffer, SceneData, path_trace
from ..render.raygen import generate_rays_padded, pixel_grid
from ..render.sampling import rand2
from ..render.sky import SkyMaps
from ..utils.config import FeatureFlags, RenderParams


class FrameState(NamedTuple):
    """Mutable (functionally-threaded) per-frame state."""

    vertices: jnp.ndarray      # (V,3)
    normals: jnp.ndarray       # (V,3)
    history: DenoiseHistory
    exposure: jnp.ndarray      # (4,)
    frame_idx: jnp.ndarray     # () uint32
    time: jnp.ndarray = None   # () f32 accumulated animation time


def displace_wave(vertices, time, amp=0.35, freq=0.5, speed=1.5):
    """In-jit vertex displacement: traveling waves along y — the analog of
    the reference's MeshDisplace hook (src/kernel.cu:139-217).  Runs every
    frame; the two-level LBVH rebuild absorbs the animated geometry."""
    x = vertices[:, 0]
    z = vertices[:, 2]
    dy = amp * jnp.sin(freq * x + time * speed) \
        * jnp.cos(freq * 0.8 * z + time * 1.1)
    return vertices.at[:, 1].add(dy)


def displace_wave_rows(tris_t, time, amp=0.35, freq=0.5, speed=1.5):
    """The same traveling wave applied directly to the SORTED (9, P)
    triangle table (rows 0-2/3-5/6-8 = v0/v1/v2).  The displacement is a
    pure function of (x, z), so per-slot application needs ZERO gathers —
    duplicate slots (row-aligned leaf padding) displace identically."""
    out = tris_t
    for b in (0, 3, 6):
        x = tris_t[b]
        z = tris_t[b + 2]
        dy = amp * jnp.sin(freq * x + time * speed) \
            * jnp.cos(freq * 0.8 * z + time * 1.1)
        out = out.at[b + 1].add(dy)
    return out


def wave_normal_rows(nrm_t, tris_t, time, amp=0.35, freq=0.5, speed=1.5):
    """EXACT shading-normal transform under p' = p + d(x,z)·ŷ.

    The displacement Jacobian is J = I + ŷ∇dᵀ with det J = 1, so normals
    map by the inverse-transpose: n' = n - ∇d·n_y, i.e.
        n'_x = n_x - ∂d/∂x · n_y,   n'_z = n_z - ∂d/∂z · n_y.
    Analytic, per-row, zero gathers — replacing the segment-sum smooth-
    normal recompute the reference does after MeshDisplace
    (src/kernel.cu:313-327), and exact where that is an average.
    nrm_t/tris_t: (9, P) sorted rows (undisplaced positions)."""
    out = []
    for b in (0, 3, 6):
        x = tris_t[b]
        z = tris_t[b + 2]
        pa = freq * x + time * speed
        pb = freq * 0.8 * z + time * 1.1
        ddx = amp * freq * jnp.cos(pa) * jnp.cos(pb)
        ddz = -amp * freq * 0.8 * jnp.sin(pa) * jnp.sin(pb)
        ny = nrm_t[b + 1]
        nx = nrm_t[b] - ddx * ny
        nz = nrm_t[b + 2] - ddz * ny
        il = jax.lax.rsqrt(jnp.maximum(nx * nx + ny * ny + nz * nz, 1e-20))
        out += [nx * il, ny * il, nz * il]
    return jnp.stack(out)


def interleave_rows(a, b):
    """Row-interleave two (h2, w, ...) arrays into (2*h2, w, ...):
    out[0::2] = a, out[1::2] = b.

    Lowered as two interior-padded `lax.pad` ops + add — a form XLA keeps
    in the image's native layout (a (h/2, 2, w) stack/reshape would
    propagate hostile tiling through the denoise chain, ROADMAP fact #6).
    Works for float and integer planes (pad value 0, disjoint rows)."""
    zero = jnp.zeros((), a.dtype)
    ca = [(0, 1, 1)] + [(0, 0, 0)] * (a.ndim - 1)
    cb = [(1, 0, 1)] + [(0, 0, 0)] * (a.ndim - 1)
    return jax.lax.pad(a, zero, ca) + jax.lax.pad(b, zero, cb)


class FrameStatic(NamedTuple):
    """Static (hashable) frame configuration — part of the jit key."""

    render_w: int
    render_h: int
    screen_w: int
    screen_h: int
    num_batches: int
    flags: FeatureFlags
    max_traversal_steps: int = 1024
    trace: str = "xla"        # "kernel" (GPU per-lane traversal,
    #   bvh/lane_traverse.py) | "xla" (the wavefront reference); the Engine
    #   takes it from lane_traverse.trace_route()
    sah_leaf: int = 1         # leaf width of the prebuilt flat SAH tree
    #   (8 = row-aligned multi-tri leaves, bvh/sah.py::_collapse_leaves);
    #   only consulted when the static-scene prebuilt tables are in use
    animation: str = "none"   # none | wave — in-jit vertex displacement
    interlace: bool = False   # interlaced sparse rendering: each frame
    #   traces HALF the pixel rows (y = 2i + frame parity), the
    #   reconstruction interleaves traced rows with vertical-neighbor
    #   fills, and the temporal accumulator — which already integrates
    #   jittered 1-spp samples across frames — sees every row at full rate
    #   over any 2-frame window.  A counterpart of the reference's
    #   resolution/perf trade (its dynamic resolution,
    #   src/kernel.cu:78-114): trace cost ~halves while the OUTPUT grid
    #   (G-buffer, history, denoise, post) stays full-res, so static
    #   detail converges to the full-rate image instead of being upscaled
    #   away
    stop_after: str = "full"  # full | bvh | trace | denoise — profiling
    #   harness cut points: the frame program ends after the named stage so
    #   stage cost = t(stage_k) - t(stage_{k-1}).  The reference gets this
    #   for free from its per-stage cudaDeviceSynchronize
    #   (src/kernel.cu:282-396); the fused XLA frame needs deliberate cuts.


def compute_smooth_normals(vertices, indices):
    """Area-weighted vertex normals via segment_sum — the atomic-free analog
    of the reference's GenerateSmoothNormals (src/kernel.cu:228-257)."""
    v0 = vertices[indices[:, 0]]
    v1 = vertices[indices[:, 1]]
    v2 = vertices[indices[:, 2]]
    fn = jnp.cross(v1 - v0, v2 - v0)  # area-weighted
    nv = vertices.shape[0]
    acc = (segment_sum(fn, indices[:, 0], nv)
           + segment_sum(fn, indices[:, 1], nv)
           + segment_sum(fn, indices[:, 2], nv))
    norm = jnp.linalg.norm(acc, axis=-1, keepdims=True)
    return acc / jnp.maximum(norm, 1e-12)


def build_scene_tables(num_batches: int, indices, tri_mat, valid, verts, nrm):
    """Two-level LBVH rebuild + sorted per-triangle attribute prep
    (the bvh.cu:7-97 analog).  Returns (bvh, tri_nrm_t, sorted_mat).

    Called per frame for animated geometry; for static scenes the Engine
    runs it ONCE at init and feeds the result into `render_frame` via
    `prebuilt` — the reference rebuilds unconditionally every frame
    (src/kernel.cu:328-333) even though its scene is static.
    """
    b = num_batches
    tv0 = verts[indices[:, 0]].reshape(b, BATCH_SIZE, 3)
    tv1 = verts[indices[:, 1]].reshape(b, BATCH_SIZE, 3)
    tv2 = verts[indices[:, 2]].reshape(b, BATCH_SIZE, 3)
    bvh = build_scene_bvh(tv0, tv1, tv2, valid)

    # per-triangle attributes in sorted leaf order, packed wide.  The
    # batch-local permutation (indices + material id) goes through the
    # one-hot matmul gather; the global vertex-normal fetch stays an XLA
    # gather (vertex index space is too wide to one-hot).
    from ..ops.gather import onehot_permute
    sort_idx = bvh.sorted_tri_index
    reorder = (sort_idx.reshape(b, BATCH_SIZE)
               - (jnp.arange(b, dtype=jnp.int32) * BATCH_SIZE)[:, None])
    perm = onehot_permute(
        jnp.concatenate([indices.reshape(b, BATCH_SIZE, 3),
                         tri_mat.reshape(b, BATCH_SIZE, 1)], axis=-1),
        reorder)
    flat_idx = perm[..., 0:3].reshape(-1, 3)
    sorted_mat = perm[..., 3].reshape(-1)
    tri_nrm_t = jnp.concatenate(
        [nrm[flat_idx[:, 0]].T, nrm[flat_idx[:, 1]].T,
         nrm[flat_idx[:, 2]].T], axis=0)  # (9, T) column-major
    return bvh, tri_nrm_t, sorted_mat


def render_frame(static: FrameStatic, indices, tri_mat, valid, materials,
                 textures, sky: SkyMaps, lights, state: FrameState,
                 camera: Camera, prev_camera: Camera, params: RenderParams,
                 dt, prebuilt=None, row_sharding=None, trace_mesh=None):
    """One full frame.  Returns (u8 image (screen_h, screen_w, 3), new state).

    indices/tri_mat/valid: padded static scene arrays (engine/scene.py);
    materials/textures: static tables; sky: baked maps.

    prebuilt: optional (bvh, tri_nrm_t, sorted_mat) from
    `build_scene_tables` or `bvh.sah.build_scene_tables_sah` — skips the
    in-frame LBVH rebuild for static scenes (only honored when
    static.animation == "none").

    row_sharding: optional callable applying a row-axis sharding constraint
    to an (H, W, ...) image array (parallel/frame_spmd.py).  When set, the
    G-buffer, denoised frame and history are pinned to the mesh's row
    shards and XLA's SPMD partitioner propagates the sharding through the
    WHOLE frame program — denoise stencils get automatic halo exchanges,
    the exposure histogram becomes an all-reduce.  trace_mesh: the same
    mesh, for the traversal kernel, which runs per device under
    `shard_map` (a kernel call cannot be partitioned by GSPMD).
    """
    w, h = static.render_w, static.render_h
    sw, sh = static.screen_w, static.screen_h
    b = static.num_batches
    frame_idx = state.frame_idx

    # ---- geometry gather + two-level LBVH rebuild (bvh.cu:7-97 analog) ----
    leaf_width = 1
    if prebuilt is not None and static.animation == "none":
        leaf_width = static.sah_leaf
        bvh, tri_nrm_t, sorted_mat = prebuilt
    else:
        verts = state.vertices
        nrm = state.normals
        if static.animation == "wave":
            t_now = (state.time if state.time is not None
                     else state.frame_idx.astype(jnp.float32) * dt)
            verts = displace_wave(verts, t_now)
            # re-derive smooth normals for the displaced surface
            # (reference recomputes after MeshDisplace, kernel.cu:313-327)
            nrm = compute_smooth_normals(verts, indices)
        bvh, tri_nrm_t, sorted_mat = build_scene_tables(
            b, indices, tri_mat, valid, verts, nrm)
    if static.stop_after == "bvh":
        return (bvh.boxes_t, bvh.children_t, bvh.tris_t, tri_nrm_t), state
    scene = SceneData(
        bvh=bvh,
        tri_nrm_t=tri_nrm_t,
        tri_mat=sorted_mat,
        materials=materials,
        sky=sky,
        textures=textures,
        lights=lights,
    )

    # ---- raygen (1 spp) ----
    cam = camera._replace(aperture=params.sample.aperture,
                          focal_dist=params.sample.focal_dist)
    basis = camera_basis(cam)
    prev_basis = camera_basis(prev_camera)
    n_pix = w * h
    interlace = static.interlace and h % 2 == 0
    parity = (frame_idx & jnp.uint32(1)).astype(jnp.int32)
    ht = h // 2 if interlace else h   # traced pixel rows this frame
    if interlace:
        # interlaced: traced row i is image row 2i+parity.  pixel_ids is
        # data (seeds + uv derive from it), so one compiled program serves
        # both fields
        yy = jnp.arange(ht, dtype=jnp.int32) * 2 + parity
    else:
        yy = jnp.arange(h, dtype=jnp.int32)
    pixel_ids = (yy[:, None] * w
                 + jnp.arange(w, dtype=jnp.int32)[None, :]).reshape(-1)
    # inter-pixel blue-noise sample distribution: per-pixel CP offsets from
    # the tiled void-and-cluster mask (reference: blueNoiseRandGen.h tiles)
    if static.flags.blue_noise:
        from ..render.sampling import blue_offsets_flat, rand2_bn
        rows = blue_offsets_flat(w, h, n_pix).reshape(h, w, 2)
        if interlace:
            # each field gets ITS rows' offsets (static slices of the
            # numpy mask; the traced parity just selects)
            bn = jnp.where(parity == 1,
                           jnp.asarray(rows[1::2].reshape(-1, 2)),
                           jnp.asarray(rows[0::2].reshape(-1, 2)))
        else:
            bn = jnp.asarray(rows.reshape(n_pix, 2))
        jitter = rand2_bn(bn, frame_idx, jnp.uint32(0))
        lens = rand2_bn(bn, frame_idx, jnp.uint32(256))
    else:
        bn = None
        jitter = rand2(pixel_ids, frame_idx, jnp.uint32(0))
        lens = rand2(pixel_ids, frame_idx, jnp.uint32(256))
    rays = generate_rays_padded(basis, w, h, pixel_ids, jitter, lens)

    # optional composed environment: sky + ocean + stars for escaped rays
    # (the reference's dormant sky2 -> star -> water chain, active here
    # behind static flags — render/environment.py)
    if static.flags.ocean or static.flags.stars:
        from ..render.environment import env_radiance_scene
        t_env = (state.time if state.time is not None
                 else frame_idx.astype(jnp.float32) * dt)
        env_fn = lambda o, d: env_radiance_scene(
            sky, o, d, t_env, ocean=static.flags.ocean,
            stars=static.flags.stars)
    else:
        env_fn = None

    # ---- path trace ----
    gbuf: GBuffer = path_trace(
        scene, rays, pixel_ids, frame_idx, prev_basis,
        w / h, max_steps=static.max_traversal_steps, trace=static.trace,
        use_proctex=static.flags.procedural_textures, bn=bn,
        env_fn=env_fn, leaf_width=leaf_width, mesh=trace_mesh)
    crop = lambda x: x.reshape((ht, w) + x.shape[1:])

    # live NaN guards in the hot path under RTRT_DEBUG=1 (the reference
    # wires NAN_DETECTER into its hot kernels, src/pathtrace.cuh:113-117);
    # no-ops (and identical programs) when the flag is off
    from ..utils.debug import nan_guard
    shard = row_sharding if row_sharding is not None else (lambda x: x)
    if interlace:
        # full-res reconstruction: traced rows land at y = 2i+parity,
        # missing rows fill from vertical neighbors — LINEAR for radiance
        # planes (halves comb artifacts pre-denoise), NEAREST for geometry
        # planes (averaging depth/ids across silhouettes invents surfaces
        # that would poison the temporal validity test).  The temporal
        # filter then overwrites filled rows with reprojected history
        # wherever it is valid; a static camera sees every row every 2
        # frames, so accumulation converges to the full-rate image.
        def _lin(c):
            nxt = jnp.concatenate([c[1:], c[-1:]], axis=0)
            prv = jnp.concatenate([c[:1], c[:-1]], axis=0)
            even = interleave_rows(c, (c + nxt) * 0.5)
            odd = interleave_rows((prv + c) * 0.5, c)
            return jnp.where(parity == 1, odd, even)

        def _nn(c):
            # replicate: rows 2i and 2i+1 both read traced row i — the
            # result is parity-independent, so no select is needed
            return interleave_rows(c, c)
    else:
        _lin = _nn = lambda c: c
    color = shard(nan_guard(_lin(crop(gbuf.color)), "trace.radiance"))
    albedo = shard(nan_guard(_lin(crop(gbuf.albedo)), "trace.albedo"))
    normal = shard(nan_guard(_nn(crop(gbuf.normal)), "trace.normal"))
    depth = shard(_nn(crop(gbuf.depth)))
    mat_id = shard(_nn(crop(gbuf.mat_id)))
    motion = shard(nan_guard(_nn(crop(gbuf.motion)), "trace.motion"))
    if static.stop_after == "trace":
        return (color, albedo, normal, depth, mat_id, motion), state

    # ---- SVGF denoise ----
    if static.flags.denoise:
        parity = (frame_idx & 1).astype(jnp.int32)
        final, new_history = denoise(color, albedo, normal, depth, mat_id,
                                     motion, state.history, params.denoise,
                                     static.flags, frame_parity=parity)
    else:
        final = color * albedo
        new_history = state.history
    if static.stop_after == "denoise":
        return (final, new_history), state

    # ---- postprocess ----
    sun_uv, sun_z = world_to_screen(basis, basis.pos + sky.sun_dir * 1e4,
                                    w / h)
    # sun visibility: depth at the sun pixel is sky (reference LensFlarePred)
    sx = jnp.clip((sun_uv[0] * w).astype(jnp.int32), 0, w - 1)
    sy = jnp.clip((sun_uv[1] * h).astype(jnp.int32), 0, h - 1)
    sun_visible = jnp.where((sun_z > 0) & ~jnp.isfinite(depth[sy, sx]),
                            1.0, 0.0)

    if static.flags.postprocess:
        image, new_exposure = postprocess(final, state.exposure, dt, sun_uv,
                                          sun_visible, params.post,
                                          static.flags, sh, sw, frame_idx)
    else:
        ldr = jnp.clip(final, 0.0, 1.0) ** (1.0 / 2.2)
        if (sh, sw) != (h, w):
            from ..ops.resize import upscale_catmull_rom
            ldr = jnp.clip(upscale_catmull_rom(ldr, sh, sw), 0.0, 1.0)
        image = (ldr * 255.0 + 0.5).astype(jnp.uint8)
        new_exposure = state.exposure

    new_time = (state.time + dt) if state.time is not None else None
    new_state = FrameState(vertices=state.vertices, normals=state.normals,
                           history=new_history, exposure=new_exposure,
                           frame_idx=frame_idx + 1, time=new_time)
    return image, new_state


def make_frame_fn(static: FrameStatic):
    """Compile the frame program for a static configuration."""
    return jax.jit(partial(render_frame, static))
