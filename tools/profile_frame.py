"""Per-pass frame profiler: stage timing via stop_after cut points.

The reference gets per-stage timing for free from its per-stage
cudaDeviceSynchronize serialization (reference: src/kernel.cu:282-396);
our frame is ONE fused XLA program, so stage cost is measured by compiling
the frame program truncated after each stage (FrameStatic.stop_after) and
differencing the wall times (each closed by `block_until_ready`).  XLA
fusion across the cut boundary is lost, so the deltas are an upper bound on
each stage's marginal cost — good enough to rank optimization targets.

Usage:
    python tools/profile_frame.py [--scene terrain] [--width 1920]
        [--height 1080] [--frames 5] [--route kernel|xla]

Prints a table: cumulative ms per cut + per-stage delta.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAGES = ["bvh", "trace", "denoise", "full"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default=os.environ.get("BENCH_SCENE", "terrain"))
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--stages", default=",".join(STAGES),
                    help="comma list of cut points to time")
    ap.add_argument("--rebuild", action="store_true",
                    help="force the in-frame LBVH rebuild (drop the engine's "
                         "static-scene prebuilt tables) so the bvh stage cut "
                         "measures build cost")
    ap.add_argument("--route", choices=("kernel", "xla"), default=None,
                    help="traversal route (default: the backend's, "
                         "bvh/lane_traverse.trace_route)")
    args = ap.parse_args()

    import jax

    from rtrt_tpu.engine.engine import Engine
    from rtrt_tpu.engine.frame import make_frame_fn
    from rtrt_tpu.utils.cache import enable_compile_cache
    from rtrt_tpu.utils.config import DynamicResolution, GlobalSettings

    enable_compile_cache()

    # terrain_big / terrain_huge follow bench.py's chunk mapping (the
    # ~230k / ~1M-tri envelope configs)
    chunks = {"terrain_big": 10, "terrain_huge": 21}.get(args.scene, 4)
    scene = "terrain" if args.scene.startswith("terrain") else args.scene
    settings = GlobalSettings(
        render_width=args.width, render_height=args.height, scene=scene,
        texture_size=256, terrain_chunks=chunks,
        dynamic_resolution=DynamicResolution(enabled=False))
    eng = Engine(settings)
    static = eng._static                      # the live bucket's config
    if args.route:
        static = static._replace(trace=args.route)
    frame_args = eng._frame_args(dt=1 / 60)   # same inputs the engine uses
    if args.rebuild:
        frame_args = frame_args[:-1] + (None,)  # null the prebuilt slot

    stages = [s.strip() for s in args.stages.split(",")]
    cum = {}
    for stage in stages:
        fn = make_frame_fn(static._replace(stop_after=stage))
        jax.block_until_ready(fn(*frame_args))   # compile + warm
        # chained frames (the state output feeds the next call), one block
        t0 = time.perf_counter()
        for _ in range(args.frames):
            out, new_state = fn(*frame_args)
            frame_args = frame_args[:7] + (new_state,) + frame_args[8:]
        jax.block_until_ready(out)
        cum[stage] = (time.perf_counter() - t0) / args.frames * 1e3

    print(f"\nscene={args.scene} tris={eng.scene.num_tris} "
          f"{args.width}x{args.height} trace={static.trace} "
          f"{jax.devices()[0].device_kind} ({args.frames} frames/stage)")
    print(f"{'cut':<10}{'cumulative ms':>14}{'stage delta ms':>16}")
    prev = 0.0
    for stage in stages:
        print(f"{stage:<10}{cum[stage]:>14.1f}{cum[stage] - prev:>16.1f}")
        prev = cum[stage]


if __name__ == "__main__":
    main()
