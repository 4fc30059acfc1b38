"""Traversal timing on the card: the GPU lane kernel's block shapes and the
XLA wavefront reference's chunk sizes, on the benchmark scene's rays.

Builds the benchmark Engine (terrain_chunks=4, static SAH tree) at
1920x1080, takes the primary rays and one diffuse bounce segment's rays
(chip_smoke.trace_rays), and times each traversal variant on both ray sets
with `block_until_ready` after a warm-up call.  Compile time is reported
apart.  Prints one line per variant and, last, one JSON object.

Usage:  python tools/trace_bench.py [--blocks 32x1,64x2,128x4]
            [--chunks 32768,131072,524288,2097152] [--reps 5]
"""

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _time(fn, args, reps):
    """(first-call seconds, median ms of reps warmed calls)."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ms.append((time.perf_counter() - t0) * 1e3)
    return first, statistics.median(ms)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", default="32x1,64x2,128x4",
                    help="kernel variants, rays-per-block x warps")
    ap.add_argument("--chunks", default="32768,131072,524288,2097152",
                    help="XLA reference chunk sizes (rays per while loop)")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import jax

    from chip_smoke import compare_hits, nvidia_smi_line, terrain_engine, \
        trace_rays
    from rtrt_tpu.bvh.lane_traverse import intersect_lanes
    from rtrt_tpu.bvh.traverse import intersect_scene
    from rtrt_tpu.utils.cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU; JAX found {dev.platform}")
    enable_compile_cache()
    card = nvidia_smi_line()
    print(card, flush=True)
    eng = terrain_engine()
    bvh, leaf = eng.prebuilt[0], eng._static.sah_leaf
    ray_sets = trace_rays(eng)
    results = []

    ref = {}
    for c in [int(x) for x in args.chunks.split(",") if x]:
        fn = jax.jit(lambda b, o, d, t, c=c: intersect_scene(
            b, o, d, t, leaf_width=leaf, chunk=c))
        for name, o, d, t in ray_sets:
            first, ms = _time(fn, (bvh, o, d, t), args.reps)
            ref.setdefault(name, fn(bvh, o, d, t))
            row = dict(route="xla", chunk=c, rays=name, ms=ms,
                       first_call_s=first)
            results.append(row)
            print(json.dumps(row), flush=True)

    for spec in [x for x in args.blocks.split(",") if x]:
        block, warps = (int(v) for v in spec.split("x"))
        fn = jax.jit(lambda b, o, d, t, block=block, warps=warps:
                     intersect_lanes(b, o, d, t, leaf_width=leaf,
                                     block=block, num_warps=warps))
        for name, o, d, t in ray_sets:
            first, ms = _time(fn, (bvh, o, d, t), args.reps)
            row = dict(route="kernel", block=block, warps=warps, rays=name,
                       ms=ms, first_call_s=first)
            if name in ref:
                dis, rel, _ = compare_hits(fn(bvh, o, d, t), ref[name])
                row.update(disagree=dis, max_rel_t=rel)
            results.append(row)
            print(json.dumps(row), flush=True)

    print(json.dumps({"card": card, "device_kind": dev.device_kind,
                      "rays_per_set": int(ray_sets[0][1].shape[0]),
                      "results": results}))


if __name__ == "__main__":
    main()
