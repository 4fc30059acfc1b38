"""Multi-chip SPMD sharding of the REAL frame program.

The reference is strictly single-GPU (its only cross-device transport is
CUDA<->Vulkan interop, SURVEY.md §2.8); here the scaling story is SPMD
tile parallelism over a `jax.sharding.Mesh`.  `parallel/tile.py` shows it
on a reduced pipeline with hand-written collectives; THIS module shards the
actual
product frame — `engine.frame.render_frame`, with the full temporal
reprojection, the complete SVGF chain, bloom/flare/exposure post — with
no duplicated pipeline code.

Design: XLA's SPMD partitioner, not hand-written collectives.  We pin the
image-space anchors of the frame program (G-buffer planes, denoised frame,
history carry, output image) to a row sharding `P("rows")` via
`with_sharding_constraint` (hooked into `render_frame(row_sharding=...)`),
and let the partitioner propagate shardings through the whole fused
program.  It auto-inserts exactly the collectives the round-1 manual
variant hand-rolled — halo exchanges for the denoise stencils
(`ppermute`-equivalent), an all-reduce for the exposure histogram
(`psum`), gathers only where genuinely global data is needed (arbitrary
motion reprojection, bloom's low-res pyramid tail).  Scene tables, BVH
and camera are replicated: the BVH rebuild is redundant per chip, which
is the right trade at these scales (rebuild is ~10% of frame; sharding it
would put a cross-chip dependency in front of every trace step).

This is "pick a mesh, annotate shardings, let XLA insert collectives"
(the scaling-book recipe) applied to a renderer.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..engine.frame import FrameState, FrameStatic, render_frame

AXIS = "rows"


def make_row_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the first n devices (image rows shard across it)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (AXIS,))


def _row_spec(x) -> P:
    """Shard dim 0 (the image H axis), replicate the rest."""
    return P(AXIS, *([None] * (x.ndim - 1)))


def _row_sharder(mesh: Mesh):
    def shard(x):
        if getattr(x, "ndim", 0) == 0:
            return x
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(mesh, _row_spec(x)))
    return shard


def shard_frame_state(mesh: Mesh, state: FrameState) -> FrameState:
    """Place the frame state on the mesh: image-shaped history buffers row
    sharded, everything else (vertices, exposure, counters) replicated."""
    rep = NamedSharding(mesh, P())

    def put_row(x):
        if x is None:
            return None
        if getattr(x, "ndim", 0) >= 2:  # (H,W,...) history planes
            return jax.device_put(x, NamedSharding(mesh, _row_spec(x)))
        return jax.device_put(x, rep)  # scalars (valid flag)

    def put_rep(x):
        return jax.device_put(x, rep) if x is not None else None

    hist = jax.tree_util.tree_map(put_row, state.history)
    rest = jax.tree_util.tree_map(
        put_rep, state._replace(history=None))
    return rest._replace(history=hist)


def replicate(mesh: Mesh, tree):
    """Replicate a pytree (scene tables, sky, camera, params) on the mesh."""
    rep = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, rep) if hasattr(x, "shape") else x, tree)


def make_spmd_frame_fn(mesh: Mesh, static: FrameStatic):
    """jit-compile the real frame program for the mesh.

    Requires render_h (and screen_h) divisible by the mesh size so row
    shards are equal.  The trace follows static.trace:

    * "kernel" — the GPU traversal kernel runs per device under
      `shard_map` (bvh/lane_traverse.intersect): rays shard by image row,
      scene tables replicate, each card traces its own row block.
    * "xla" — the wavefront reference, partitioned automatically by GSPMD
      from the row-sharding constraints.
    """
    n = mesh.devices.size
    assert static.render_h % n == 0 and static.screen_h % n == 0, \
        f"render_h={static.render_h} must divide over {n} row shards"
    fn = partial(render_frame, static, row_sharding=_row_sharder(mesh),
                 trace_mesh=mesh if static.trace == "kernel" else None)
    return jax.jit(fn)


def sharded_refit(mesh: Mesh, plan, tris_t, n_leaves: int,
                  leaf_width: int = 8):
    """BVH refit with the O(T) leaf-bounds stage SHARDED over the mesh.

    The replicated-BVH trade documented above is right for the full
    morton/Karras REBUILD (cross-chip dependencies in front of every
    trace step), but the animated-scene REFIT path (bvh/refit.py) splits
    cleanly: per-leaf AABBs are an embarrassingly-parallel reduction over
    the triangle table (the O(T) part — shard it), while the level-sweep
    box fit is O(nodes) ~ T/24 and cheap (replicate it).  Leaves are
    row-aligned `leaf_width` groups, so sharding the LEAF axis keeps
    every reduction shard-local; constraining the (n_leaves, 3) bounds
    replicated afterwards makes XLA insert one all-gather of
    2 * n_leaves * 12 bytes — for the 1M-tri envelope, ~3 MB over the interconnect
    instead of a redundant 64 MB/device of leaf reduction traffic.

    Returns the refitted raw (q, 32) node table (replicated), as
    `refit_nodes4` does.
    """
    from ..bvh.refit import leaf_bounds, refit_nodes4

    n = mesh.devices.size
    assert n_leaves % n == 0, \
        f"n_leaves={n_leaves} must divide over {n} shards (pad the build)"
    nv = n_leaves * leaf_width
    tt = tris_t[:, :nv]
    # shard triangle columns (whole leaves per shard: nv/n % leaf_width==0)
    tt = jax.lax.with_sharding_constraint(
        tt, NamedSharding(mesh, P(None, AXIS)))
    lo, hi = leaf_bounds(tt, n_leaves, leaf_width)
    rep = NamedSharding(mesh, P())
    lo = jax.lax.with_sharding_constraint(lo, rep)   # one small all-gather
    hi = jax.lax.with_sharding_constraint(hi, rep)
    return refit_nodes4(plan, lo, hi)
