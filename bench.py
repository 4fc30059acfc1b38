"""Benchmark: ms/frame of the full engine pipeline on the GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

Measures the complete per-frame program (static prebuilt SAH tree or the
per-frame LBVH rebuild, 1-spp path trace through the GPU traversal kernel,
SVGF denoise, postprocess, quantize), timed as chained frames closed by
`block_until_ready`.  `vs_baseline` is the ratio of the reference's
33.3 ms/frame target (30 FPS north star, BASELINE.json) to our time at the
same resolution — >1.0 means faster than target.

The headline scene is the marching-cubes Perlin terrain (~37k triangles) —
the reference's own default content (reference: src/init.cu:82-97); the
962-tri demo scene is available via BENCH_SCENE=demo for kernel-level
comparisons only.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BENCH_W = int(os.environ.get("BENCH_WIDTH", 1920))
BENCH_H = int(os.environ.get("BENCH_HEIGHT", 1080))
FRAMES = int(os.environ.get("BENCH_FRAMES", 10))
SCENE = os.environ.get("BENCH_SCENE", "terrain")
# ANIMATION=wave measures the DYNAMIC-GEOMETRY frame: per-frame vertex
# displacement + the full two-level LBVH rebuild inside the jitted program
# (the reference's defining workload rebuilds the tree every frame,
# src/kernel.cu:328-333).  Default "none" = static scene, prebuilt tree.
ANIMATION = os.environ.get("ANIMATION", "none")


def main():
    import jax

    from rtrt_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    from rtrt_tpu.engine.engine import Engine
    from rtrt_tpu.utils.config import DynamicResolution, GlobalSettings

    # terrain_big: the >=200k-tri config; terrain_huge: ~1M tris, the top
    # of the reference's scene envelope (src/kernel.cuh:54-55 — 1,048,576).
    # Plain terrain (36.8k) is the headline scene.
    chunks = {"terrain_big": 10, "terrain_huge": 21}.get(SCENE, 4)
    scene = "terrain" if SCENE.startswith("terrain") else SCENE
    settings = GlobalSettings(
        render_width=BENCH_W, render_height=BENCH_H, scene=scene,
        texture_size=256, terrain_chunks=chunks,
        dynamic_resolution=DynamicResolution(enabled=False))
    eng = Engine(settings, animation=ANIMATION)

    # warmup/compile
    eng.render_frame_device(dt=1 / 60)
    eng.render_frame_device(dt=1 / 60)

    # device frame THROUGHPUT: dispatch all frames (each chained on the
    # previous frame's state, so they serialize on the device), then block
    fn = eng._frame_fns[eng._cur_bucket]
    t0 = time.perf_counter()
    img = None
    for _ in range(FRAMES):
        img, new_state = fn(*eng._frame_args(1 / 60))
        eng.state = new_state
    jax.block_until_ready(img)
    ms = (time.perf_counter() - t0) / FRAMES * 1e3

    target_ms = 33.333  # 30 FPS north star @1080p (BASELINE.json)
    n_rays = eng.render_w * eng.render_h * 5
    dev = jax.devices()[0]

    # BASELINE.md metric row: ms/frame AND Mrays/s.  The frame runs 5 scene
    # intersects per pixel (primary + shadow/bounce segments, matching the
    # reference's ~5/pixel bounce program, src/pathtrace.cuh:53-105)
    mrays = n_rays / (ms / 1e3) / 1e6
    print(json.dumps({
        "metric": (f"ms_per_frame_{eng.render_w}x{eng.render_h}_1spp_"
                   f"denoised_{SCENE}_{eng.scene.num_tris}tris"
                   + ("_animated" if ANIMATION != "none" else "")
                   + ("_interlaced"
                      if os.environ.get("RTRT_INTERLACE") == "1" else "")),
        "value": round(ms, 2),
        "unit": "ms",
        "vs_baseline": round(target_ms / ms, 4),
        "mrays_per_s": round(mrays, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
