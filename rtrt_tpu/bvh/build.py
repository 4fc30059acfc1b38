"""Per-frame two-level LBVH construction, atomic-free and fully vectorized.

Counterpart of the reference's BLAS/TLAS rebuild chain
(reference: src/updateGeometry.cuh:65-364 geometry+morton,
src/radixSort.cuh:21-246 per-batch sort, src/buildBVH.cuh:18-271 Karras
build + atomicCAS bottom-up AABB fit, orchestrated by src/bvh.cu:7-97).

Re-architecture for XLA:
  * the 1024-triangle batch contract is kept (it makes every shape static);
    batches are a leading array axis and every stage is vmapped over it.
  * radix sort        -> jax.lax.sort (vectorized merge network, no ballots)
  * Karras topology   -> the same binary searches, but as fixed-trip-count
    masked loops vectorized over all internal nodes at once
  * AABB fit          -> NO atomics: every internal node covers a contiguous
    sorted-leaf range (Karras invariant), so node boxes are two O(1) lookups
    in a doubling sparse table (ops/reduce.py) — O(N log N), data-parallel
  * TLAS leaves are pre-resolved to BLAS roots at pack time, so traversal
    needs no TLAS-leaf branch (see types.py).

The builder is jit-compatible end-to-end and runs inside the per-frame
program for animated geometry.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.geometry import triangle_aabb
from ..ops.morton import morton3d_30, normalize_to_aabb
from ..ops.reduce import build_minmax_table, range_minmax
from ..ops.sort import sort_key_index
from .types import (BATCH_SIZE, BLAS_NODES, GROUP, GROUPS_PER_BATCH,
                    SceneBvh, pack_entry)

UINT_MAX = jnp.uint32(0xFFFFFFFF)


# ---------------------------------------------------------------------------
# Karras 2012 topology (vectorized over internal nodes; vmap over batches)
# ---------------------------------------------------------------------------


def _clz32(x):
    return jax.lax.clz(x.astype(jnp.int32) if x.dtype != jnp.int32 else x)


def lbvh_topology(codes):
    """Compute LBVH topology for N sorted morton codes (N static, >= 2).

    Returns (left, right, first, last): each (N-1,) int32 where left/right use
    the convention `child >= 0` = internal node index, `child < 0` = leaf
    index encoded as ~child; first/last = inclusive sorted-leaf range of the
    internal node.  Duplicate codes are handled by the standard index-XOR
    tiebreak (equivalent to appending the leaf index to the key).
    """
    n = codes.shape[0]
    codes = codes.astype(jnp.uint32)
    log2n = max(1, (n - 1).bit_length())
    i = jnp.arange(n - 1, dtype=jnp.int32)

    # The Karras searches are reformulated to keep gathers out of them, around the sorted-code LCP identity
    #     delta(i, j) = min(adj[min(i,j) .. max(i,j)-1]),
    # where adj[k] = delta(k, k+1) is computed once by a SHIFT.  A
    # doubling min-table over adj (built by shifts) turns the whole
    # exponential phase into aligned table reads — zero gathers — and the
    # two binary descents into ONE gather per level instead of a
    # two-sided code fetch + xor/clz per probe.  Out-of-range propagates
    # exactly: adj pads with -1 and min(-1, x) = -1 = delta's own
    # out-of-range sentinel.
    ca = codes[:n - 1]
    cb1 = codes[1:]
    x = (ca ^ cb1).astype(jnp.int32)
    adj = jnp.where(x != 0, _clz32(x),
                    32 + _clz32((i ^ (i + 1)) | 1))  # (n-1,) LCP(k, k+1)

    # tab[k][p] = min(adj[p .. p+2^k-1]), -1 past the end
    tab = [adj]
    for k in range(log2n):
        prev = tab[-1]
        sh = jnp.concatenate(
            [prev[1 << k:], jnp.full((min(1 << k, n - 1),), -1, jnp.int32)])
        tab.append(jnp.minimum(prev, sh))

    def rmin(tk, pos):
        """tk[pos] with out-of-range -> -1 (pos may be any int array)."""
        ok = (pos >= 0) & (pos < n - 1)
        return jnp.where(ok, tk[jnp.clip(pos, 0, n - 2)], -1)

    def delta_at(lvl, start):
        """delta over a 2^lvl-long adjacent range starting at `start`."""
        return rmin(tab[lvl], start)

    adj_left = jnp.concatenate([jnp.full((1,), -1, jnp.int32), adj[:-1]])

    # direction: toward the longer common prefix
    d = jnp.where(adj >= adj_left, 1, -1).astype(jnp.int32)
    delta_min = jnp.where(d > 0, adj_left, adj)

    # exact range length l by binary descent from the top level: grow l by
    # 2^k when the NEXT 2^k adjacent deltas (one gather per level) stay
    # > delta_min.  The running min of committed blocks IS delta(i, j).
    l = jnp.zeros_like(i)
    delta_node = jnp.full_like(i, 127)  # min-identity over an empty range
    for k in range(log2n, -1, -1):
        nxt = jnp.where(d > 0, i + l, i - l - (1 << k))
        probe = delta_at(k, nxt)
        grow = probe > delta_min
        l = jnp.where(grow, l + (1 << k), l)
        delta_node = jnp.where(grow, jnp.minimum(delta_node, probe),
                               delta_node)
    j = i + l * d

    # split position: the longest prefix (from i toward d) whose adjacent
    # deltas all stay > delta_node — the same monotone-predicate descent
    s = jnp.zeros_like(i)
    for k in range(log2n, -1, -1):
        nxt = jnp.where(d > 0, i + s, i - s - (1 << k))
        grow = delta_at(k, nxt) > delta_node
        s = jnp.where(grow, s + (1 << k), s)

    gamma = i + s * d + jnp.minimum(d, 0)
    first = jnp.minimum(i, j)
    last = jnp.maximum(i, j)
    left = jnp.where(first == gamma, ~gamma, gamma)
    right = jnp.where(last == gamma + 1, ~(gamma + 1), gamma + 1)
    return left, right, first, last


def fit_node_boxes(left, right, first, last, gamma, leaf_lo, leaf_hi):
    """Compute each internal node's packed child-AABB-pair row.

    left child covers sorted leaves [first, gamma], right covers
    [gamma+1, last]; both are O(1) sparse-table range queries.
    Returns boxes (N-1, 12) f32.
    """
    lo_t, hi_t = build_minmax_table(leaf_lo, leaf_hi)
    llo, lhi = range_minmax(lo_t, hi_t, first, gamma)
    rlo, rhi = range_minmax(lo_t, hi_t, gamma + 1, last)
    return jnp.concatenate([llo, lhi, rlo, rhi], axis=-1)


def _gamma_from_children(left, right):
    """Recover the split leaf index from the child encoding."""
    return jnp.where(left < 0, ~left, left)


# ---------------------------------------------------------------------------
# full scene build
# ---------------------------------------------------------------------------


def build_scene_bvh(v0, v1, v2, valid) -> SceneBvh:
    """Build the full two-level BVH.

    Args:
      v0, v1, v2: (B, 1024, 3) f32 triangle vertices (padded slots arbitrary).
      valid: (B, 1024) bool — False for padding triangles.
    Returns:
      SceneBvh with triangles permuted into sorted leaf order.

    B must be >= 2 (pad with an empty batch if needed).
    """
    b = v0.shape[0]
    assert v0.shape[1] == BATCH_SIZE and b >= 2, (v0.shape, b)

    # --- per-triangle AABBs; padding is an empty box (never hit) ------------
    lo, hi = triangle_aabb(v0, v1, v2)
    lo = jnp.where(valid[..., None], lo, jnp.inf)
    hi = jnp.where(valid[..., None], hi, -jnp.inf)

    # --- batch AABBs + morton codes ----------------------------------------
    batch_lo = jnp.min(lo, axis=1)  # (B,3)
    batch_hi = jnp.max(hi, axis=1)
    centers = 0.5 * (lo + hi)
    unit = normalize_to_aabb(centers, batch_lo[:, None, :], batch_hi[:, None, :])
    codes = morton3d_30(jnp.where(valid[..., None], unit, 0.0))
    codes = jnp.where(valid, codes, UINT_MAX)  # padding sorts to the end

    # --- per-batch sort (reorder = sorted slot -> original in-batch index) --
    sorted_codes, reorder = sort_key_index(codes)

    # apply the permutation to all vertex columns with ONE exact one-hot
    # matmul (ops/gather.py) instead of per-column gathers.  Only FINITE columns may ride the matmul (0 * inf = NaN), so the
    # sorted leaf AABBs (whose padding slots are ±inf empty boxes) are
    # recomputed from the sorted vertices + permuted valid mask instead.
    from ..ops.gather import onehot_permute
    s = onehot_permute(
        jnp.concatenate([v0, v1, v2, valid[..., None].astype(jnp.float32)],
                        axis=-1), reorder)
    s_v0, s_v1, s_v2 = s[..., 0:3], s[..., 3:6], s[..., 6:9]
    s_valid = s[..., 9] > 0.5
    # padding triangles collapse to a degenerate point at the origin: a
    # GROUP leaf tests all its GROUP slots unconditionally, and a
    # degenerate triangle (det == 0) can never pass the watertight test
    s_v0 = jnp.where(s_valid[..., None], s_v0, 0.0)
    s_v1 = jnp.where(s_valid[..., None], s_v1, 0.0)
    s_v2 = jnp.where(s_valid[..., None], s_v2, 0.0)
    s_lo, s_hi = triangle_aabb(s_v0, s_v1, s_v2)
    s_lo = jnp.where(s_valid[..., None], s_lo, jnp.inf)
    s_hi = jnp.where(s_valid[..., None], s_hi, -jnp.inf)

    # --- GROUP morton-adjacent triangles per leaf ----------------------------
    # Leaf AABB = union over the group's valid slots (all-padding groups
    # stay empty and are never visited); the group key is its first
    # (smallest) member code, which preserves sortedness.  See types.GROUP.
    g_lo = s_lo.reshape(b, GROUPS_PER_BATCH, GROUP, 3).min(axis=2)
    g_hi = s_hi.reshape(b, GROUPS_PER_BATCH, GROUP, 3).max(axis=2)
    g_codes = sorted_codes[:, ::GROUP]

    # --- BLAS topology + AABB fit (vmapped over batches) --------------------
    left, right, first, last = jax.vmap(lbvh_topology)(g_codes)
    gamma = _gamma_from_children(left, right)
    blas_boxes = jax.vmap(fit_node_boxes)(left, right, first, last, gamma,
                                          g_lo, g_hi)  # (B, GROUPS-1, 12)

    # --- pack BLAS children as stack entries --------------------------------
    batch_ids = jnp.arange(b, dtype=jnp.int32)[:, None]

    def pack_blas(child):
        is_leaf = child < 0
        idx = jnp.where(is_leaf, ~child, child)
        return pack_entry(idx, batch_ids, True, is_leaf)

    blas_children = jnp.stack([pack_blas(left), pack_blas(right)], axis=-1)

    # --- TLAS over batch root AABBs -----------------------------------------
    valid_batch = jnp.any(valid, axis=1)
    t_lo = jnp.where(valid_batch[:, None], batch_lo, jnp.inf)
    t_hi = jnp.where(valid_batch[:, None], batch_hi, -jnp.inf)
    root_lo = jnp.min(t_lo, axis=0)
    root_hi = jnp.max(t_hi, axis=0)
    t_centers = normalize_to_aabb(0.5 * (t_lo + t_hi), root_lo, root_hi)
    t_codes = jnp.where(valid_batch, morton3d_30(t_centers), UINT_MAX)
    t_sorted, t_reorder = sort_key_index(t_codes)  # (B,)
    ts_lo = t_lo[t_reorder]
    ts_hi = t_hi[t_reorder]

    t_left, t_right, t_first, t_last = lbvh_topology(t_sorted)
    t_gamma = _gamma_from_children(t_left, t_right)
    tlas_boxes = fit_node_boxes(t_left, t_right, t_first, t_last, t_gamma,
                                ts_lo, ts_hi)  # (B-1, 12)

    # TLAS child packing: leaves resolve directly to their batch's BLAS root
    def pack_tlas(child):
        is_leaf = child < 0
        leaf = jnp.where(is_leaf, ~child, 0)
        leaf_batch = t_reorder[leaf]
        # leaf -> BLAS root (internal node 0 of that batch)
        leaf_entry = pack_entry(jnp.zeros_like(child), leaf_batch, True, False)
        node_entry = pack_entry(jnp.maximum(child, 0), 0, False, False)
        return jnp.where(is_leaf, leaf_entry, node_entry)

    tlas_children = jnp.stack([pack_tlas(t_left), pack_tlas(t_right)], axis=-1)

    # --- flatten: TLAS rows first, then all BLAS rows -----------------------
    flat_boxes = jnp.concatenate(
        [tlas_boxes, blas_boxes.reshape(b * BLAS_NODES, 12)], axis=0)
    flat_children = jnp.concatenate(
        [tlas_children, blas_children.reshape(b * BLAS_NODES, 2)], axis=0)

    sorted_tri_index = (batch_ids * BATCH_SIZE + reorder).reshape(-1)
    t = b * BATCH_SIZE
    tris_t = jnp.concatenate(
        [s_v0.reshape(t, 3).T, s_v1.reshape(t, 3).T, s_v2.reshape(t, 3).T],
        axis=0)  # (9, T) column-major for in-loop component gathers
    return SceneBvh(
        boxes_t=flat_boxes.T,
        children_t=flat_children.T,
        tris_t=tris_t,
        sorted_tri_index=sorted_tri_index,
        root_lo=root_lo,
        root_hi=root_hi,
    )
