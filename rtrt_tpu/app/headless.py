"""Headless CLI: render / benchmark / record without a display.

The reference's app shell is a Vulkan window (SURVEY.md §2.7); on a
headless accelerator host the presentation layer is a file or an HTTP
stream (app/viewer.py).  This
CLI covers the benchmark/record mode: N frames, FPS stats, PNG/PPM dumps —
the analog of the reference's DUMP_FRAME_NUM debug path
(reference: src/kernel.cuh:44-45, src/kernel.cu:378-391).

Usage:
  python -m rtrt_tpu.app.headless --scene demo --width 480 --height 270 \
      --frames 8 --out /tmp/frame.png [--orbit] [--config cfg.toml]
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    p = argparse.ArgumentParser(description="rtrt_tpu headless renderer")
    p.add_argument("--config", default=None, help="TOML config path")
    p.add_argument("--scene", default=None, help="demo | terrain | mesh:<path>")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--out", default="frame.png", help=".png or .ppm output")
    p.add_argument("--record", default=None,
                   help="directory: dump every frame as frame_%%04d.png")
    p.add_argument("--orbit", action="store_true",
                   help="orbit the camera (exercises motion vectors)")
    p.add_argument("--no-denoise", action="store_true")
    p.add_argument("--no-post", action="store_true")
    p.add_argument("--ocean", action="store_true",
                   help="raymarched environment ocean (water.cuh twin)")
    p.add_argument("--stars", action="store_true",
                   help="night star field (star.cuh twin; pair with "
                        "--time-of-day near 0.0/1.0)")
    p.add_argument("--time-of-day", type=float, default=None)
    args = p.parse_args(argv)

    import dataclasses
    from ..engine.engine import Engine
    from ..utils.config import (DynamicResolution, FeatureFlags,
                                GlobalSettings, load_config, set_param)
    from ..utils.image import write_png, write_ppm

    settings = load_config(args.config)
    over = {}
    if args.scene:
        over["scene"] = args.scene
    if args.width:
        over["render_width"] = args.width
    if args.height:
        over["render_height"] = args.height
    over["dynamic_resolution"] = DynamicResolution(enabled=False)
    settings = dataclasses.replace(settings, **over)

    flags = FeatureFlags(denoise=not args.no_denoise,
                         postprocess=not args.no_post,
                         ocean=args.ocean, stars=args.stars)
    eng = Engine(settings, flags=flags)
    if args.time_of_day is not None:
        eng.params = set_param(eng.params, "sky.time_of_day",
                               args.time_of_day)

    import math
    img = None
    t_first = time.perf_counter()
    eng.render_frame(dt=1 / 60)  # compile
    t_compiled = time.perf_counter()
    times = []
    for i in range(args.frames):
        if args.orbit:
            eng.camera = eng.camera._replace(yaw=eng.camera.yaw + 0.02)
        t0 = time.perf_counter()
        img = eng.render_frame(dt=1 / 60)
        times.append(time.perf_counter() - t0)
        if args.record:
            import os
            os.makedirs(args.record, exist_ok=True)
            write_png(f"{args.record}/frame_{i:04d}.png", img)
    avg = sum(times) / len(times)
    print(f"compile: {t_compiled - t_first:.1f}s | "
          f"{args.frames} frames @ {eng.render_w}x{eng.render_h}: "
          f"{avg * 1e3:.1f} ms/frame ({1 / avg:.1f} FPS)")

    if args.out.endswith(".ppm"):
        write_ppm(args.out, img)
    else:
        write_png(args.out, img)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
