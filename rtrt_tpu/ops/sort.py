"""Batched key/value sorting.

Counterpart of the reference's block-level LSD radix sort
(reference: src/radixSort.cuh:21-246): the reference sorts each 1024-key
batch inside one thread block with warp ballots; here the idiomatic move
is `jax.lax.sort` over the trailing axis — XLA lowers it to an efficient
vectorized bitonic/merge network, no atomics, and it vmaps over the batch
axis for free.  The padding convention matches the reference: invalid slots
carry key = UINT32_MAX and sort to the end (reference: src/init.cu:166).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

PAD_KEY = jnp.uint32(0xFFFFFFFF)


def sort_key_index(keys):
    """Sort (..., N) uint keys along the last axis; also return the gather
    indices (`reorder`) mapping sorted position -> original position, the
    analog of the reference's reorderIdx output.

    num_keys=2 (the iota is a SECONDARY KEY, not just payload): duplicate
    morton codes are common, and XLA may duplicate a sort op during
    optimization with tie orders that DISAGREE between the copies — we
    observed a constant-folded copy permuting ties differently from the
    runtime copy, silently building a BVH whose triangle order didn't match
    its own topology.  Unique composite keys make every copy agree."""
    n = keys.shape[-1]
    iota = jnp.broadcast_to(
        jax.lax.broadcasted_iota(jnp.int32, keys.shape, keys.ndim - 1), keys.shape)
    sorted_keys, reorder = jax.lax.sort([keys, iota], dimension=-1, num_keys=2)
    return sorted_keys, reorder


def sort_key_val(keys, vals):
    """Sort (..., N) keys with a same-shape value payload along the last axis."""
    return jax.lax.sort_key_val(keys, vals, dimension=-1)
