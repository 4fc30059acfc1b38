"""BVH data layout and stack-entry encoding.

Counterpart of the reference's 64-byte BVHNode + bit-packed
traversal stack entries (reference: src/bvhNode.cuh:5-13, src/traverse.h:9-86).

Layout decisions (all static-shape, SoA):
  * One node row = the two child AABBs packed as 12 floats
    [Llo, Lhi, Rlo, Rhi] — one gather fetches both boxes (the reference's
    AABBCompact pair-test amortization).
  * TLAS and all BLAS node arrays are concatenated into ONE flat array so the
    traversal loop issues a single gather regardless of level:
        flat index = idx                      (TLAS internal node)
                   = TLAS_N + batch*1023+idx  (BLAS internal node)
  * Child slots store *pre-packed stack entries* (see below), so TLAS leaves
    are resolved to their batch's BLAS root at build time and the hot loop
    never branches on "TLAS leaf".

Stack entry packing (int32):
    bits  0..10  node index within its level, or BLAS leaf GROUP index
                 (leaf triangles = batch*BATCH_SIZE + idx*GROUP .. +GROUP-1)
    bits 11..21  batch index (<= 1023)
    bit  22      is_blas
    bit  23      is_leaf  (BLAS leaf -> GROUP triangle tests)
    -1           invalid / empty slot
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

BATCH_SIZE = 1024          # triangles per BLAS batch (reference: src/kernel.cuh:579)
# Leaves hold GROUP morton-adjacent triangles (the reference uses 1
# tri/leaf, src/buildBVH.cuh:18-271).  Wider leaves trade vector
# triangle tests for internal traversal steps; the two-level LBVH keeps 1
# (static scenes get multi-triangle leaves from the SAH build instead).
GROUP = 1
GROUPS_PER_BATCH = BATCH_SIZE // GROUP
BLAS_NODES = GROUPS_PER_BATCH - 1
MAX_BATCHES = 1024         # reference: src/init.cu:126
STACK_DEPTH = 48           # reference uses 16 (src/traverse.h:26) for its
                           # two-level tree; flat SAH trees (bvh/sah.py) can
                           # run ~2x log2(N) deep, so the wavefront stack is
                           # sized for the 1M-tri envelope (overflow drops
                           # the far child, as in the reference)
MAX_TRAVERSAL_STEPS = 1024  # reference: src/traverse.h:132

ENTRY_INVALID = jnp.int32(-1)

_IDX_BITS = 11
_BATCH_SHIFT = 11
_BLAS_BIT = jnp.int32(1 << 22)
_LEAF_BIT = jnp.int32(1 << 23)
_IDX_MASK = jnp.int32((1 << _IDX_BITS) - 1)
_BATCH_MASK = jnp.int32((1 << 11) - 1)


def pack_entry(idx, batch, is_blas, is_leaf):
    idx = idx.astype(jnp.int32) if hasattr(idx, "astype") else jnp.int32(idx)
    e = (idx & _IDX_MASK) | ((jnp.int32(batch) & _BATCH_MASK) << _BATCH_SHIFT)
    e = e | jnp.where(is_blas, _BLAS_BIT, 0) | jnp.where(is_leaf, _LEAF_BIT, 0)
    return e


def entry_idx(e):
    return e & _IDX_MASK


def entry_batch(e):
    return (e >> _BATCH_SHIFT) & _BATCH_MASK


def entry_is_blas(e):
    return (e & _BLAS_BIT) != 0


def entry_is_leaf(e):
    return (e & _LEAF_BIT) != 0


class SceneBvh(NamedTuple):
    """Complete two-level BVH over a batched triangle soup.

    Triangle arrays are in *sorted leaf order* (the builder permutes them so a
    BLAS leaf maps directly to tri = batch*1024 + leaf_idx with no reorder
    indirection).  Shape-derived statics: B = tri_v0.shape[0] // 1024;
    TLAS internal count = flat_boxes.shape[0] - B*1023.
    """

    # COLUMN-MAJOR tables: leading axis = component, trailing = element.
    # Inside the serial traversal while_loop, per-component (N,) gathers from
    # (M,) columns keep everything in the native T(1024) lane layout; row
    # gathers of (N,12) tiles land components on the 128-lane minor axis and
    # force a relayout transpose PER slice PER iteration (measured ~40x).
    boxes_t: jnp.ndarray      # (12, tlas_internal + B*1023) f32 child AABB pair
    children_t: jnp.ndarray   # (2, tlas_internal + B*1023) i32 packed entries
    tris_t: jnp.ndarray       # (9, B*1024) f32 sorted [v0x..v2z]
    sorted_tri_index: jnp.ndarray  # (B*1024,) i32: sorted slot -> original tri id
    root_lo: jnp.ndarray      # (3,) scene AABB
    root_hi: jnp.ndarray

    @property
    def tri_v0(self) -> jnp.ndarray:
        return self.tris_t[0:3].T

    @property
    def tri_v1(self) -> jnp.ndarray:
        return self.tris_t[3:6].T

    @property
    def tri_v2(self) -> jnp.ndarray:
        return self.tris_t[6:9].T

    @property
    def num_batches(self) -> int:
        return self.tris_t.shape[1] // BATCH_SIZE

    @property
    def tlas_internal(self) -> int:
        return self.boxes_t.shape[1] - self.num_batches * BLAS_NODES
