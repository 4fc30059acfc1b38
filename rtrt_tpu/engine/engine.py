"""Engine: the public host runtime (init / render_frame / input / persist).

Counterpart of the reference's `RayTracer` host object
(reference: src/kernel.cuh:431-621 — init at src/init.cu:53, draw at
src/kernel.cu:259, input at src/inputControl.cu:29-150), re-shaped around
functional state: the Engine owns numpy/host state plus a jit-compiled frame
executable per resolution bucket and threads the device-side `FrameState`
through each call.

Includes:
  * dynamic resolution controller (bucketed static shapes; reference scales
    width continuously at kernel.cu:78-114 — we snap to precompiled buckets
    to avoid recompiles);
  * WASD+mouse fly camera and Ctrl+C/Ctrl+V-style camera save/load
    (reference: src/inputControl.cu:29-150, camera.bin -> camera.json);
  * sky regeneration only on parameter change (reference: kernel.cu:285-308).
"""

from __future__ import annotations

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..bvh.lane_traverse import trace_route
from ..core.camera import Camera, make_camera
from ..denoise.pipeline import init_history
from ..post.exposure import init_exposure_state
from ..render.sky import (bake_sky_maps, finalize_sky_maps, make_sky_params,
                          sun_direction_from_time)
from ..render.texture import make_soil_textures
from ..utils.config import (FeatureFlags, GlobalSettings, RenderParams,
                            default_params)
from ..utils.timer import FpsLog, Timer
from .frame import FrameState, FrameStatic, make_frame_fn
from .scene import (HostScene, build_demo_scene, build_mesh_scene,
                    build_terrain_scene, padded_arrays)

_BUCKET_HEIGHTS = (270, 360, 540, 720, 1080, 1440, 2160)


def _bucket_for(height: int):
    for h in _BUCKET_HEIGHTS:
        if h >= height:
            return h
    return _BUCKET_HEIGHTS[-1]


def _res_for_height(h: int):
    """16:9, width snapped to a multiple of 16 (reference: kernel.cu:96-98)."""
    w = (h * 16 // 9) // 16 * 16
    return w, h


class Engine:
    """Public API: `Engine(settings).render_frame() -> (H,W,3) uint8`."""

    def __init__(self, settings: GlobalSettings | None = None,
                 flags: FeatureFlags | None = None,
                 scene: HostScene | None = None,
                 params: RenderParams | None = None,
                 animation: str = "none"):
        self.settings = settings or GlobalSettings()
        self.flags = flags or FeatureFlags()
        self.params = params or default_params()
        self.animation = animation

        # ---- content (reference init.cu:82-97) ----
        if scene is not None:
            self.scene = scene
        elif self.settings.scene == "terrain":
            self.scene = build_terrain_scene(self.settings)
        elif self.settings.scene == "demo":
            self.scene = build_demo_scene()
        elif self.settings.scene.startswith("mesh:"):
            from ..content.meshio import load_mesh
            v, f = load_mesh(self.settings.scene[5:])
            self.scene = build_mesh_scene(v, f)
        else:
            raise ValueError(f"unknown scene '{self.settings.scene}'")

        pad = padded_arrays(self.scene)
        self.indices = jnp.asarray(pad["indices"])
        self.tri_mat = jnp.asarray(pad["tri_mat"])
        self.valid = jnp.asarray(pad["valid"])
        self.materials = self.scene.materials
        self.lights = getattr(self.scene, "lights", None)
        self.textures = make_soil_textures(self.settings.texture_size)
        # the traversal route, from the backend (raises on an unknown one)
        self._trace = trace_route()

        # ---- sky (regenerated on param change) ----
        self._sky_key = None
        self._bake_sky = jax.jit(bake_sky_maps, static_argnames=("model",))
        self.sky = None
        self._maybe_regen_sky()

        # ---- camera ----
        self.camera = make_camera(pos=(0.0, 8.0, -18.0), yaw=0.0, pitch=-0.25,
                                  fov_y=1.1)
        self.prev_camera = self.camera
        if self.settings.load_camera_at_init and \
                os.path.exists(self.settings.camera_path):
            self.load_camera(self.settings.camera_path)

        # ---- device frame state ----
        self.state = FrameState(
            vertices=jnp.asarray(self.scene.vertices),
            normals=jnp.asarray(self.scene.normals),
            history=init_history(1, 1, half=self.flags.half_history),  # re-inited per bucket below
            exposure=init_exposure_state(),
            frame_idx=jnp.uint32(0),
            time=jnp.float32(0.0),
        )

        # ---- static scenes: build the BVH + sorted tri tables ONCE ----
        # (the per-frame in-jit rebuild stays the path for animated
        # geometry; the reference rebuilds unconditionally, kernel.cu:328)
        self.prebuilt = None
        self._sah_leaf = 1
        if self.animation == "none" and \
                os.environ.get("RTRT_PREBUILD", "1") != "0":
            if os.environ.get("RTRT_SAH", "1") != "0":
                # static scenes get the high-quality binned-SAH flat tree
                # (host/native build, init-time only — bvh/sah.py), with
                # row-aligned multi-triangle leaves
                from ..bvh.sah import build_scene_tables_sah
                self._sah_leaf = int(os.environ.get("RTRT_LEAF_WIDTH", "8"))
                self.prebuilt = build_scene_tables_sah(
                    self.scene.num_batches, self.indices, self.tri_mat,
                    self.valid, self.state.vertices, self.state.normals,
                    leaf_max=self._sah_leaf)
            else:
                from .frame import build_scene_tables
                build = jax.jit(build_scene_tables, static_argnums=0)
                self.prebuilt = jax.block_until_ready(build(
                    self.scene.num_batches, self.indices, self.tri_mat,
                    self.valid, self.state.vertices, self.state.normals))

        # ---- resolution buckets ----
        self._frame_fns = {}
        self._precompiling = set()
        self._cur_bucket = None
        self.render_w = self.render_h = 0
        self._set_bucket(_bucket_for(self.settings.render_height))
        if self.settings.dynamic_resolution.enabled:
            self._precompile_neighbors()

        self.timer = Timer()
        self.fps_log = FpsLog()
        self._input = dict(keys=set(), last_cursor=None)

    # ------------------------------------------------------------------
    # resolution buckets / dynamic resolution
    # ------------------------------------------------------------------

    def _static_for(self, bucket_h: int) -> FrameStatic:
        w, h = _res_for_height(bucket_h)
        return FrameStatic(
            render_w=w, render_h=h,
            screen_w=self.settings.render_width,
            screen_h=self.settings.render_height,
            num_batches=self.scene.num_batches,
            flags=self.flags,
            trace=self._trace,
            sah_leaf=self._sah_leaf,
            animation=self.animation,
            # interlaced sparse rendering: trace half the pixel rows per
            # frame (alternating parity), reconstruct full-res before the
            # denoiser.  Settings field or RTRT_INTERLACE=1/0 override.
            interlace=(os.environ.get(
                "RTRT_INTERLACE",
                "1" if getattr(self.settings, "interlace", False) else "0")
                == "1" and h % 2 == 0))

    def _set_bucket(self, bucket_h: int):
        if bucket_h == self._cur_bucket:
            return
        self._cur_bucket = bucket_h
        self.render_w, self.render_h = _res_for_height(bucket_h)
        static = self._static_for(bucket_h)
        self._static = static
        if bucket_h not in self._frame_fns:
            self._frame_fns[bucket_h] = make_frame_fn(static)
        # history buffers are resolution-dependent — reset on switch
        self.state = self.state._replace(
            history=init_history(self.render_h, self.render_w,
                                 half=self.flags.half_history))

    def _precompile_bucket_async(self, bucket_h: int):
        """Warm one bucket's frame executable in a daemon thread (compile +
        one throwaway execution, so the switch reuses a hot jit cache).

        The reference re-allocates continuously-sized buffers on resolution
        change (kernel.cu:78-114) — free on CUDA, but each static-shape
        bucket here is a fresh XLA compile (minutes cold at 1080p).  Without
        warming, the first frame after a dynamic-resolution switch hitches
        for the whole compile."""
        if (bucket_h in self._frame_fns or bucket_h in self._precompiling
                or os.environ.get("RTRT_PRECOMPILE", "1") == "0"):
            return
        import threading
        self._precompiling.add(bucket_h)
        static = self._static_for(bucket_h)
        fn = make_frame_fn(static)

        def work():
            try:
                state = self.state._replace(history=init_history(
                    static.render_h, static.render_w,
                    half=self.flags.half_history))
                args = (self.indices, self.tri_mat, self.valid,
                        self.materials, self.textures, self.sky, self.lights,
                        state, self.camera, self.camera, self.params,
                        jnp.float32(1 / 60), self.prebuilt)
                jax.block_until_ready(fn(*args))
                self._frame_fns[bucket_h] = fn
            except Exception:
                pass  # precompile is best-effort; the switch still works
            finally:
                self._precompiling.discard(bucket_h)

        threading.Thread(target=work, daemon=True,
                         name=f"rtrt-precompile-{bucket_h}").start()

    def _precompile_neighbors(self):
        """Kick background warms for the buckets one step down and up."""
        idx = _BUCKET_HEIGHTS.index(self._cur_bucket)
        for j in (idx - 1, idx + 1):
            if 0 <= j < len(_BUCKET_HEIGHTS) and \
                    _BUCKET_HEIGHTS[j] <= max(self.settings.render_height,
                                              _BUCKET_HEIGHTS[0]):
                self._precompile_bucket_async(_BUCKET_HEIGHTS[j])

    def _dynamic_resolution_step(self, frame_time: float):
        """Scale the bucket to hold the target frame time
        (reference controller: kernel.cu:78-114, here bucket-snapped)."""
        dr = self.settings.dynamic_resolution
        if not dr.enabled or frame_time <= 0.0:
            return
        fps = 1.0 / frame_time
        idx = _BUCKET_HEIGHTS.index(self._cur_bucket)
        if fps < dr.target_fps - dr.deadband_fps and idx > 0:
            self._set_bucket(_BUCKET_HEIGHTS[idx - 1])
            self._precompile_neighbors()
        elif fps > dr.target_fps + dr.deadband_fps * 4 and \
                idx < len(_BUCKET_HEIGHTS) - 1:
            nh = _BUCKET_HEIGHTS[idx + 1]
            if nh <= self.settings.render_height:
                self._set_bucket(nh)
                self._precompile_neighbors()

    # ------------------------------------------------------------------
    # sky regeneration (reference: kernel.cu:285-308)
    # ------------------------------------------------------------------

    def _maybe_regen_sky(self):
        sp = self.params.sky
        key = tuple(float(x) for x in (sp.time_of_day, sp.sun_axis_angle,
                                       sp.sun_intensity, sp.rayleigh, sp.mie,
                                       sp.mie_g))
        if key == self._sky_key:
            return
        self._sky_key = key
        sun = sun_direction_from_time(sp.time_of_day, float(sp.sun_axis_angle))
        elev = math.asin(max(-1.0, min(1.0, float(sun[1]))))
        azim = math.atan2(float(sun[0]), float(sun[2]))
        sky_params = make_sky_params(
            sun_elevation=elev, sun_azimuth=azim,
            sun_intensity=float(sp.sun_intensity),
            rayleigh_scale=float(sp.rayleigh), mie_scale=float(sp.mie),
            mie_g=float(sp.mie_g))
        self.sky = finalize_sky_maps(self._bake_sky(
            sky_params, model=self.settings.sky_model))

    # ------------------------------------------------------------------
    # per-frame
    # ------------------------------------------------------------------

    def render_frame_device(self, dt: float | None = None):
        """Render one frame; returns the (screen_h, screen_w, 3) uint8 image
        as a DEVICE array (synced).  Use this for benchmarking / chaining —
        the host copy is a separate step."""
        if dt is None:
            dt = self.timer.update()
        self._update_camera_from_input(dt)
        self._maybe_regen_sky()

        fn = self._frame_fns[self._cur_bucket]
        image, new_state = fn(*self._frame_args(dt))
        self.state = new_state
        self.prev_camera = self.camera
        self._dynamic_resolution_step(dt)
        self.fps_log.maybe_log(self.timer.fps, self.render_w, self.render_h)
        image.block_until_ready()
        return image

    def render_frame(self, dt: float | None = None) -> np.ndarray:
        """Render one frame; returns (screen_h, screen_w, 3) uint8 on host."""
        return np.asarray(self.render_frame_device(dt))

    def _frame_args(self, dt: float):
        """The positional argument tuple for the current frame function
        (also consumed by tools/profile_frame.py's stage cuts)."""
        return (self.indices, self.tri_mat, self.valid, self.materials,
                self.textures, self.sky, self.lights, self.state,
                self.camera, self.prev_camera, self.params,
                jnp.float32(max(dt, 1e-4)), self.prebuilt)

    # ------------------------------------------------------------------
    # input control (reference: src/inputControl.cu:29-113)
    # ------------------------------------------------------------------

    MOVE_SPEED = 8.0
    LOOK_SPEED = 0.003

    def key_event(self, key: str, down: bool):
        key = key.lower()
        if down:
            self._input["keys"].add(key)
        else:
            self._input["keys"].discard(key)

    def cursor_event(self, x: float, y: float):
        last = self._input["last_cursor"]
        self._input["last_cursor"] = (x, y)
        if last is None:
            return
        dx, dy = x - last[0], y - last[1]
        self.camera = self.camera._replace(
            yaw=self.camera.yaw + dx * self.LOOK_SPEED,
            pitch=float(np.clip(self.camera.pitch - dy * self.LOOK_SPEED,
                                -1.5, 1.5)))

    def _update_camera_from_input(self, dt: float):
        keys = self._input["keys"]
        if not keys:
            return
        cy, sy = math.cos(float(self.camera.yaw)), math.sin(float(self.camera.yaw))
        fwd = np.array([sy, 0.0, cy])
        right = np.array([cy, 0.0, -sy])
        move = np.zeros(3)
        if "w" in keys:
            move += fwd
        if "s" in keys:
            move -= fwd
        if "d" in keys:
            move += right
        if "a" in keys:
            move -= right
        if "c" in keys:
            move += np.array([0.0, 1.0, 0.0])
        if "x" in keys:
            move -= np.array([0.0, 1.0, 0.0])
        if np.any(move):
            pos = np.asarray(self.camera.pos) + move * (self.MOVE_SPEED * dt)
            self.camera = self.camera._replace(pos=jnp.asarray(pos, jnp.float32))

    # ------------------------------------------------------------------
    # camera persistence (reference: inputControl.cu:115-150, camera.bin)
    # ------------------------------------------------------------------

    def save_camera(self, path: str | None = None):
        path = path or self.settings.camera_path
        c = self.camera
        data = dict(pos=[float(x) for x in np.asarray(c.pos)],
                    yaw=float(c.yaw), pitch=float(c.pitch),
                    fov_y=float(c.fov_y), aperture=float(c.aperture),
                    focal_dist=float(c.focal_dist))
        with open(path, "w") as f:
            json.dump(data, f, indent=2)

    def load_camera(self, path: str | None = None):
        path = path or self.settings.camera_path
        with open(path) as f:
            d = json.load(f)
        self.camera = make_camera(pos=tuple(d["pos"]), yaw=d["yaw"],
                                  pitch=d["pitch"], fov_y=d["fov_y"],
                                  aperture=d["aperture"],
                                  focal_dist=d["focal_dist"])

    # ------------------------------------------------------------------
    # full-state checkpoint / resume (SURVEY.md §5.4: camera + history
    # buffers for deterministic replay)
    # ------------------------------------------------------------------

    def save_state(self, path: str):
        """Snapshot the device frame state (history buffers, exposure,
        frame counter, vertices) + camera to an npz checkpoint."""
        import jax
        flat, _ = jax.tree_util.tree_flatten(self.state)
        arrays = {f"s{i}": np.asarray(x) for i, x in enumerate(flat)}
        c = self.camera
        arrays["camera"] = np.concatenate(
            [np.asarray(c.pos),
             np.asarray([float(c.yaw), float(c.pitch), float(c.fov_y),
                         float(c.aperture), float(c.focal_dist)])])
        np.savez_compressed(path, **arrays)

    def load_state(self, path: str):
        import jax
        d = np.load(path)
        flat, treedef = jax.tree_util.tree_flatten(self.state)
        new_flat = [jnp.asarray(d[f"s{i}"]) for i in range(len(flat))]
        self.state = jax.tree_util.tree_unflatten(treedef, new_flat)
        cam = d["camera"]
        self.camera = make_camera(pos=tuple(cam[:3]), yaw=float(cam[3]),
                                  pitch=float(cam[4]), fov_y=float(cam[5]),
                                  aperture=float(cam[6]),
                                  focal_dist=float(cam[7]))
        self.prev_camera = self.camera
