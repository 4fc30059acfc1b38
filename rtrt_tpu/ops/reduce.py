"""Range reductions without atomics.

The reference fits internal-node AABBs bottom-up with an `atomicCAS`
"second thread proceeds" rendezvous (reference: src/buildBVH.cuh:186-267).
XLA wants data-parallel form without atomics, so we exploit the
LBVH invariant instead: *every internal node covers a contiguous range of
sorted leaves* (Karras 2012).  A doubling sparse table of mins/maxs turns
each node's AABB into two O(1) range lookups — O(N log N) total work, fully
vectorized, and exact (min/max are idempotent so overlapping blocks are fine).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def build_minmax_table(values_lo, values_hi):
    """Build doubling sparse tables for range-min of `values_lo` and range-max
    of `values_hi` over the second-to-last axis.

    Args:
      values_lo/hi: (..., N, C) arrays (N power of two or not — handled).
    Returns:
      (lo_table, hi_table): each (L, ..., N, C) with L = floor(log2 N)+1;
      lo_table[k, ..., i] = min(values_lo[..., i : i+2^k]) (clamped at N).
    """
    n = values_lo.shape[-2]
    levels = max(1, n.bit_length())
    lo_t = [values_lo]
    hi_t = [values_hi]
    for k in range(1, levels):
        off = 1 << (k - 1)
        prev_lo, prev_hi = lo_t[-1], hi_t[-1]
        # shift by `off` along the N axis; out-of-range pads with identity
        pad_lo = jnp.full_like(prev_lo[..., :off, :], jnp.inf)
        pad_hi = jnp.full_like(prev_hi[..., :off, :], -jnp.inf)
        shifted_lo = jnp.concatenate([prev_lo[..., off:, :], pad_lo], axis=-2)
        shifted_hi = jnp.concatenate([prev_hi[..., off:, :], pad_hi], axis=-2)
        lo_t.append(jnp.minimum(prev_lo, shifted_lo))
        hi_t.append(jnp.maximum(prev_hi, shifted_hi))
    return jnp.stack(lo_t, axis=0), jnp.stack(hi_t, axis=0)


def range_minmax(lo_table, hi_table, first, last):
    """Range min/max query over inclusive index ranges [first, last].

    Args:
      lo_table/hi_table: (L, N, C) tables from `build_minmax_table` (no batch
        dims here; vmap for batches).
      first, last: (Q,) int32 with first <= last.
    Returns:
      (lo, hi): (Q, C).
    """
    span = last - first + 1
    # k = floor(log2(span)); span >= 1
    k = (31 - jax.lax.clz(span.astype(jnp.int32))).astype(jnp.int32)
    block = jnp.left_shift(jnp.int32(1), k)
    second = last - block + 1
    lo = jnp.minimum(lo_table[k, first], lo_table[k, second])
    hi = jnp.maximum(hi_table[k, first], hi_table[k, second])
    return lo, hi


def segment_sum(data, segment_ids, num_segments):
    """Thin wrapper over jax.ops.segment_sum (used for smooth vertex normals,
    replacing the reference's atomicAdd accumulation at src/kernel.cu:219-256)."""
    return jax.ops.segment_sum(data, segment_ids, num_segments=num_segments)
