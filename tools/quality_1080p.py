"""Product-resolution quality evidence for PARITY.md (VERDICT r2 item 7).

Runs the tests/test_quality.py methodology at the PRODUCT resolution on the
real frame program (terrain scene): accumulate an N-spp
converged reference with the denoiser off, stream M denoised 1-spp frames,
and print the SSIM trajectory — the recorded evidence that the re-baselined
quality bar (SSIM >= 0.98 vs a converged self-render; PARITY.md) holds at
1080p, not just at the CPU test's 96x54.

Usage:  python tools/quality_1080p.py [--width 1920 --height 1080]
            [--spp 64] [--frames 48] [--scene terrain]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--scene", default="terrain")
    ap.add_argument("--interlace", action="store_true",
                    help="stream engine renders interlaced (half the pixel "
                         "rows per frame); the converged reference stays "
                         "full-rate — measures the interlace quality cost")
    args = ap.parse_args()

    import jax.numpy as jnp
    import numpy as np

    from rtrt_tpu.engine.engine import Engine
    from rtrt_tpu.utils.cache import enable_compile_cache
    from rtrt_tpu.utils.config import (DynamicResolution, FeatureFlags,
                                       GlobalSettings)
    from rtrt_tpu.utils.ssim import ssim

    enable_compile_cache()
    settings = GlobalSettings(
        render_width=args.width, render_height=args.height, scene=args.scene,
        texture_size=256, dynamic_resolution=DynamicResolution(enabled=False))

    # ---- converged reference: average N raw (denoise-off) frames ----
    # postprocess stays ON in both runs (tone map etc. are deterministic),
    # so the comparison isolates 1-spp + SVGF vs N-spp.  Frames are
    # gamma-linearized (x^2.2) before averaging and re-encoded after —
    # averaging tonemapped sRGB-ish values directly is a biased stand-in
    # for an N-spp converged render (ADVICE r3, low).
    eng_ref = Engine(settings,
                     flags=FeatureFlags(denoise=False))
    acc = None
    acc_a = None  # first-half accumulation (ceiling decomposition)
    for i in range(args.spp):
        img = eng_ref.render_frame_device(dt=1 / 60)
        lin = (img.astype(jnp.float32) / 255.0) ** 2.2
        acc = lin if acc is None else acc + lin
        if i + 1 == args.spp // 2:
            acc_a = acc
    ref = np.asarray((acc / args.spp) ** (1 / 2.2))

    # ---- ceiling decomposition (VERDICT r4 item 4): the SSIM between two
    # INDEPENDENT (spp/2)-sample converged renders of the same pose bounds
    # the residual-noise term of the reference itself — no denoiser can
    # score above ~this against a single (spp/2..spp)-sample reference.
    # The two halves use disjoint frame-jitter/sample sequences.
    half_a = np.asarray((acc_a / (args.spp // 2)) ** (1 / 2.2))
    half_b = np.asarray(((acc - acc_a) / (args.spp - args.spp // 2))
                        ** (1 / 2.2))
    s_halves = ssim(half_a.astype(np.float64), half_b.astype(np.float64),
                    data_range=1.0)
    print(f"ceiling: SSIM({args.spp // 2}-spp A, {args.spp // 2}-spp B) "
          f"independent converged pair = {s_halves:.4f}", flush=True)

    # ---- denoised 1-spp stream (the product pipeline) ----
    import dataclasses
    eng = Engine(dataclasses.replace(settings, interlace=args.interlace))
    img = None
    traj = []
    for i in range(args.frames):
        img = eng.render_frame_device(dt=1 / 60)
        if (i + 1) in (1, 2, 4, 8, 16, 24, 32, args.frames):
            s = ssim(np.asarray(img).astype(np.float64) / 255.0,
                     ref.astype(np.float64), data_range=1.0)
            traj.append((i + 1, float(s)))
            print(f"frame {i + 1:3d}: SSIM vs {args.spp}-spp converged = "
                  f"{s:.4f}", flush=True)

    final = traj[-1][1]
    print(f"\n{args.width}x{args.height} {args.scene}: denoised stream "
          f"SSIM = {final:.4f} after {args.frames} frames "
          f"(bar: >= 0.98 static)")
    tag = "_interlaced" if args.interlace else ""
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "resources", f"golden_{args.scene}_"
                       f"{args.width}x{args.height}{tag}.png")
    try:
        from rtrt_tpu.utils.image import write_png
        write_png(os.path.abspath(out), np.asarray(img))
        print("golden frame pinned:", os.path.abspath(out))
    except Exception as e:  # png writer optional
        print("golden dump skipped:", e)


if __name__ == "__main__":
    main()
