"""Smoke test of the renderer on one NVIDIA GPU (or four with --four-cards).

Drives the product path once, through `Engine`, at the benchmark's
configuration — terrain scene (terrain_chunks=4, 36,834 triangles),
1920x1080, 1 spp, SVGF denoise, post, the static prebuilt SAH tree — and
checks it against the repository's plain reference, the XLA wavefront
traversal (`bvh/traverse.intersect_scene`).

Phases, one line each; any failure exits non-zero:
  1 device    JAX platform must be "gpu"; card name and power limit
  2 build     the native host library from the committed source
  3 compile   the 1080p frame: compile time, memory_analysis, and a check
              that the compiled frame runs the traversal kernel
  4 parity    traversal kernel vs intersect_scene on the card, on the
              1080p primary rays and one bounce segment's rays
  5 frames    8 frames through Engine.render_frame, frame 8 compared with
              the same frames traced by intersect_scene
  6 platforms demo scene at 256x144 on the GPU and on the CPU, compared
  7 timing    ms/frame at 1080p, kernel vs XLA traversal (informational)

--four-cards runs only the row-sharded frame (parallel/frame_spmd.py) at
1920x1080 over four GPUs, compared with the one-card frame.

The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Usage:  python3 chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1080
FRAMES = 8

# phase 4: float32 on both sides; the slack is for FMA contraction on rays
# that graze an edge (they may pick the neighbouring triangle or miss)
MAX_RAY_DISAGREE = 1e-4     # share of rays whose hit triangle differs
MAX_T_REL_ERR = 1e-5        # on rays that hit the same triangle
# phase 5: kernel vs XLA traversal through the whole frame, in 8-bit units
MAX_FRAME_MEAN_ABS = 0.05   # mean |difference| over all channels, /255
MAX_FRAME_BAD_SHARE = 1e-3  # share of channels differing by more than 4/255
# phase 6: GPU vs CPU (libm, FMA and reduction order differ, so stochastic
# MIS choices flip on a few lanes and the denoiser spreads them)
MAX_XPLAT_MEAN_ABS = 1.0    # /255
MAX_XPLAT_BAD_SHARE = 0.02  # share of channels differing by more than 16/255
# --four-cards: the GSPMD partition changes only reduction order
MAX_SHARD_MEAN_ABS = 0.05   # /255
MAX_SHARD_BAD_SHARE = 1e-3  # share of channels differing by more than 4/255


def phase(name):
    """Run one phase; print its result line, or its traceback and exit 1."""
    def wrap(fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                out = fn(*a, **k)
            except Exception:
                traceback.print_exc()
                print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f}s",
                      flush=True)
                sys.exit(1)
            print(f"[{name}] ok in {time.perf_counter() - t0:.1f}s", flush=True)
            return out
        return run
    return wrap


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def image_diff(a, b, bad_at):
    """(mean |a-b| in /255, share of channels differing by > bad_at)."""
    import numpy as np
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    return float(d.mean()), float((d > bad_at).mean())


def terrain_engine(width=W, height=H):
    """The benchmark configuration (bench.py): terrain_chunks=4, static
    prebuilt SAH tree, dynamic resolution off."""
    from rtrt_tpu.engine.engine import Engine
    from rtrt_tpu.utils.config import DynamicResolution, GlobalSettings
    return Engine(GlobalSettings(
        render_width=width, render_height=height, scene="terrain",
        texture_size=256, terrain_chunks=4,
        dynamic_resolution=DynamicResolution(enabled=False)))


def trace_rays(eng):
    """Primary rays of the engine's camera at its render size, and one
    diffuse bounce segment's rays from their hits (found by the reference;
    rays that missed carry t_max = 0, as finished lanes do in a frame).
    Returns [(name, org, dir, t_max)]."""
    import jax
    import jax.numpy as jnp

    from rtrt_tpu.bvh.traverse import intersect_scene
    from rtrt_tpu.core.camera import camera_basis
    from rtrt_tpu.render.raygen import generate_rays_padded
    from rtrt_tpu.render.sampling import rand2

    bvh = eng.prebuilt[0]
    w, h = eng.render_w, eng.render_h
    leaf = eng._static.sah_leaf

    @jax.jit
    def make(bvh):
        pix = jnp.arange(w * h, dtype=jnp.int32)
        frame = jnp.uint32(0)
        rays = generate_rays_padded(
            camera_basis(eng.camera), w, h, pix,
            rand2(pix, frame, jnp.uint32(0)), rand2(pix, frame, jnp.uint32(1)))
        hit = intersect_scene(bvh, rays.org, rays.dir, leaf_width=leaf)
        t = jnp.maximum(hit.tri, 0)
        v = [bvh.tris_t[k][t] for k in range(9)]
        e1 = jnp.stack([v[3] - v[0], v[4] - v[1], v[5] - v[2]], -1)
        e2 = jnp.stack([v[6] - v[0], v[7] - v[1], v[8] - v[2]], -1)
        ng = jnp.cross(e1, e2)
        ng = ng / jnp.maximum(jnp.linalg.norm(ng, axis=-1, keepdims=True),
                              1e-20)
        ng = jnp.where(jnp.sum(ng * rays.dir, -1, keepdims=True) > 0, -ng, ng)
        u = rand2(pix, frame, jnp.uint32(2))
        r, phi = jnp.sqrt(u[:, 0]), 2 * jnp.pi * u[:, 1]
        a = jnp.where(jnp.abs(ng[:, :1]) > 0.9, jnp.array([[0.0, 1, 0]]),
                      jnp.array([[1.0, 0, 0]]))
        tx = jnp.cross(a, ng)
        tx = tx / jnp.linalg.norm(tx, axis=-1, keepdims=True)
        ty = jnp.cross(ng, tx)
        d2 = (tx * (r * jnp.cos(phi))[:, None] + ty * (r * jnp.sin(phi))[:, None]
              + ng * jnp.sqrt(jnp.maximum(1 - u[:, :1], 0.0)))
        d2 = d2 / jnp.linalg.norm(d2, axis=-1, keepdims=True)
        o2 = rays.org + rays.dir * jnp.where(
            hit.tri >= 0, hit.t, 0.0)[:, None] + ng * 1e-3
        t2 = jnp.where(hit.tri >= 0, jnp.inf, 0.0)
        t1 = jnp.full((w * h,), jnp.inf, jnp.float32)
        return rays.org, rays.dir, t1, o2, d2, t2

    o1, d1, t1, o2, d2, t2 = make(bvh)
    return [("primary", o1, d1, t1), ("bounce", o2, d2, t2)]


def compare_hits(got, ref):
    """(share of rays whose hit triangle differs, max relative t error on
    rays that hit the same triangle, rays that hit)."""
    import numpy as np
    gt, rt = np.asarray(got.tri), np.asarray(ref.tri)
    same = (gt == rt) & (rt >= 0)
    tg, tr = np.asarray(got.t)[same], np.asarray(ref.t)[same]
    rel = float((np.abs(tg - tr) / np.maximum(np.abs(tr), 1e-30)).max()) \
        if same.any() else 0.0
    return float((gt != rt).mean()), rel, int((rt >= 0).sum())


def check_frame_hlo(text):
    """The frame's StableHLO runs every scene intersect through the
    traversal kernel: one Triton call per bounce segment and no XLA while
    loop (the wavefront reference is one while loop per ray chunk)."""
    import re

    from rtrt_tpu.render.integrator import SEGMENTS
    n = len(re.findall(r"call @intersect_lanes(_\d+)?\b", text))
    assert n == SEGMENTS, f"{n} traversal kernel calls, want {SEGMENTS}"
    assert "__gpu$xla.gpu.triton" in text, "no Triton kernel in the frame"
    assert "stablehlo.while" not in text, "XLA while loop in the frame"
    return n


def run_frames(fn, args, n):
    """n chained frames from args' state; returns (last image, ms/frame)."""
    import jax
    args = list(args)
    t0 = time.perf_counter()
    img = None
    for _ in range(n):
        img, state = fn(*args)
        args[7] = state
    jax.block_until_ready(img)
    return img, (time.perf_counter() - t0) / n * 1e3


def one_card(eng):
    """Phases 3-5 on the benchmark Engine; returns phase 7 (timing), which
    runs after phase 6."""
    import jax
    import numpy as np

    from rtrt_tpu.bvh.lane_traverse import intersect_lanes
    from rtrt_tpu.bvh.traverse import intersect_scene
    from rtrt_tpu.engine.frame import make_frame_fn

    static = eng._static
    fn = eng._frame_fns[eng._cur_bucket]
    args0 = eng._frame_args(1 / 60)

    @phase("3 compile")
    def compile_frame():
        assert static.trace == "kernel", static.trace
        t0 = time.perf_counter()
        lowered = fn.lower(*args0)
        compiled = lowered.compile()
        secs = time.perf_counter() - t0
        n_kernel = check_frame_hlo(lowered.as_text())
        mem = compiled.memory_analysis()
        print(f"[3 compile] frame {static.render_w}x{static.render_h} "
              f"trace={static.trace}: {secs:.1f}s; traversal kernel calls "
              f"in HLO: {n_kernel}; memory_analysis: "
              f"args={mem.argument_size_in_bytes / 2**20:.1f} MiB "
              f"out={mem.output_size_in_bytes / 2**20:.1f} MiB "
              f"temp={mem.temp_size_in_bytes / 2**20:.1f} MiB "
              f"code={mem.generated_code_size_in_bytes / 2**20:.2f} MiB",
              flush=True)

    @phase("4 parity")
    def parity():
        bvh = eng.prebuilt[0]
        leaf = static.sah_leaf
        ref_fn = jax.jit(lambda b, o, d, t: intersect_scene(
            b, o, d, t, leaf_width=leaf))
        for name, o, d, t in trace_rays(eng):
            got = intersect_lanes(bvh, o, d, t, leaf_width=leaf)
            ref = ref_fn(bvh, o, d, t)
            dis, rel, hits = compare_hits(got, ref)
            print(f"[4 parity] {name}: {o.shape[0]} rays, {hits} hits; "
                  f"hit-triangle disagreement {dis:.2e} (limit "
                  f"{MAX_RAY_DISAGREE:g}); max rel t err {rel:.2e} (limit "
                  f"{MAX_T_REL_ERR:g})", flush=True)
            assert dis <= MAX_RAY_DISAGREE and rel <= MAX_T_REL_ERR

    xla_fn = make_frame_fn(static._replace(trace="xla"))

    @phase("5 frames")
    def frames():
        imgs = [eng.render_frame(dt=1 / 60) for _ in range(FRAMES)]
        img = imgs[-1]
        assert img.shape == (H, W, 3) and img.dtype == np.uint8
        assert all(np.isfinite(i).all() for i in imgs)
        assert float(img.std()) > 1.0, "constant frame"
        ref, _ = run_frames(xla_fn, args0, FRAMES)
        mean_abs, bad = image_diff(img, ref, 4)
        print(f"[5 frames] {FRAMES} frames {img.shape}, std "
              f"{img.std():.1f}; frame {FRAMES} kernel vs XLA traversal: "
              f"mean |diff| {mean_abs:.4f}/255 (limit "
              f"{MAX_FRAME_MEAN_ABS}), >4/255 share {bad:.2e} (limit "
              f"{MAX_FRAME_BAD_SHARE:g})", flush=True)
        assert mean_abs <= MAX_FRAME_MEAN_ABS and bad <= MAX_FRAME_BAD_SHARE

    @phase("7 timing")
    def timing(card):
        res = {"kernel": [], "xla": []}
        for route in ("kernel", "xla", "kernel", "xla"):
            f = fn if route == "kernel" else xla_fn
            _, ms = run_frames(f, eng._frame_args(1 / 60), 10)
            res[route].append(ms)
        print(f"[7 timing] {card}: ms/frame at {W}x{H} terrain "
              f"(10 frames, in turns): kernel {res['kernel']}, "
              f"xla traversal {res['xla']}", flush=True)

    compile_frame()
    parity()
    frames()
    return timing


@phase("6 platforms")
def cross_platform():
    """Demo scene at 256x144: 4 frames on the GPU (kernel) and on the CPU
    (XLA reference) in this process."""
    import jax
    import jax.numpy as jnp

    from rtrt_tpu.core.camera import make_camera
    from rtrt_tpu.denoise.pipeline import init_history
    from rtrt_tpu.engine.frame import FrameState, FrameStatic, make_frame_fn
    from rtrt_tpu.engine.scene import build_demo_scene, padded_arrays
    from rtrt_tpu.post.exposure import init_exposure_state
    from rtrt_tpu.render.sky import (bake_sky_maps, finalize_sky_maps,
                                     make_sky_params)
    from rtrt_tpu.render.texture import make_soil_textures
    from rtrt_tpu.utils.config import FeatureFlags, default_params

    w, h = 256, 144
    scene = build_demo_scene()
    pad = padded_arrays(scene)
    out = {}
    for route, dev in (("kernel", jax.devices("gpu")[0]),
                       ("xla", jax.devices("cpu")[0])):
        with jax.default_device(dev):
            sky = finalize_sky_maps(jax.jit(bake_sky_maps)(make_sky_params()))
            state = FrameState(vertices=jnp.asarray(scene.vertices),
                               normals=jnp.asarray(scene.normals),
                               history=init_history(h, w),
                               exposure=init_exposure_state(),
                               frame_idx=jnp.uint32(0),
                               time=jnp.float32(0.0))
            cam = make_camera(pos=(0.0, 3.0, -8.0), pitch=-0.2)
            args = (jnp.asarray(pad["indices"]), jnp.asarray(pad["tri_mat"]),
                    jnp.asarray(pad["valid"]), scene.materials,
                    make_soil_textures(64), sky, scene.lights, state, cam,
                    cam, default_params(), jnp.float32(1 / 60))
            fn = make_frame_fn(FrameStatic(
                render_w=w, render_h=h, screen_w=w, screen_h=h,
                num_batches=scene.num_batches, flags=FeatureFlags(),
                trace=route))
            img, _ = run_frames(fn, args, 4)
            out[route] = img
            assert list(img.devices())[0].platform == dev.platform
    mean_abs, bad = image_diff(out["kernel"], out["xla"], 16)
    print(f"[6 platforms] demo {w}x{h} frame 4, GPU vs CPU: mean |diff| "
          f"{mean_abs:.4f}/255 (limit {MAX_XPLAT_MEAN_ABS}), >16/255 share "
          f"{bad:.2e} (limit {MAX_XPLAT_BAD_SHARE:g})", flush=True)
    assert mean_abs <= MAX_XPLAT_MEAN_ABS and bad <= MAX_XPLAT_BAD_SHARE


@phase("four-cards")
def four_cards():
    """The row-sharded frame over 4 GPUs vs the one-card frame."""
    import jax

    from rtrt_tpu.parallel.frame_spmd import (make_row_mesh,
                                              make_spmd_frame_fn, replicate,
                                              shard_frame_state)
    assert len(jax.devices()) >= 4, f"needs 4 GPUs, found {jax.devices()}"
    eng = terrain_engine()
    static = eng._static
    args = eng._frame_args(1 / 60)
    one_img, _ = run_frames(eng._frame_fns[eng._cur_bucket], args, FRAMES)
    mesh = make_row_mesh(4)
    sh_args = list(replicate(mesh, args))
    sh_args[7] = shard_frame_state(mesh, args[7])
    fn = make_spmd_frame_fn(mesh, static)
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*sh_args))
    compile_s = time.perf_counter() - t0
    img, _ = run_frames(fn, sh_args, FRAMES)
    mean_abs, bad = image_diff(img, one_img, 4)
    _, ms4 = run_frames(fn, sh_args, FRAMES)
    _, ms1 = run_frames(eng._frame_fns[eng._cur_bucket], args, FRAMES)
    print(f"[four-cards] {W}x{H} terrain, 4 GPUs row-sharded vs 1: frame "
          f"{FRAMES} mean |diff| {mean_abs:.4f}/255 (limit "
          f"{MAX_SHARD_MEAN_ABS}), >4/255 share {bad:.2e} (limit "
          f"{MAX_SHARD_BAD_SHARE:g}); first sharded call {compile_s:.1f}s; "
          f"ms/frame 4 cards {ms4:.2f}, 1 card {ms1:.2f}", flush=True)
    assert mean_abs <= MAX_SHARD_MEAN_ABS and bad <= MAX_SHARD_BAD_SHARE


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the row-sharded frame on 4 GPUs")
    args = ap.parse_args()

    sys.path.insert(0, REPO)
    import jax

    @phase("1 device")
    def device():
        dev = jax.devices()[0]
        if dev.platform != "gpu":
            raise RuntimeError(f"JAX found no GPU (platform {dev.platform})")
        card = nvidia_smi_line()
        print(card, flush=True)
        print(f"[1 device] {dev.device_kind} x{len(jax.devices())}, "
              f"jax {jax.__version__}", flush=True)
        return dev, card

    dev, card = device()

    from rtrt_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    if args.four_cards:
        four_cards()
    else:
        @phase("2 build")
        def build():
            subprocess.run(["make", "-B", "-C",
                            os.path.join(REPO, "rtrt_tpu", "native")],
                           check=True, capture_output=True, timeout=300)
            from rtrt_tpu.content import native
            assert native.available(), "native library did not load"

        build()
        eng = phase("engine")(terrain_engine)()
        timing = one_card(eng)
        cross_platform()
        timing(card)

    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
