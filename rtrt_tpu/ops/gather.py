"""One-hot gathers: exact permutation/gather as a matmul.

For BATCH-LOCAL index spaces (N <= a few thousand) the per-frame BVH build
permutes its columns with a one-hot matmul instead of per-element
gathers — the same trick the exposure histogram uses for atomicInc
(reference: src/postprocessing.cuh histogram vs post/exposure.py).  A
plain gather may serve as well on a GPU (ROADMAP).

Exactness: each one-hot row has a single 1.0, so every output element is
1.0 * value + 0 * rest.  With `precision=HIGHEST` (full float32, no TF32)
multiplying by exactly-representable 0/1 reconstructs the f32 value
bit-exactly; int32 payloads ride as f32 exactly while |x| < 2^24.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def onehot_permute(values, idx):
    """Batched gather along axis 1 via one-hot matmul.

    Args:
      values: (B, N, C) f32/i32 table (C = packed feature columns).
      idx:    (B, M) int32 indices into axis 1, each in [0, N).
    Returns:
      (B, M, C) with out[b, m] = values[b, idx[b, m]] — exact (int columns
      must satisfy |x| < 2^24).  Values must be FINITE: the masked-out
      matmul terms are 0 * value, and 0 * inf = NaN.
    """
    n = values.shape[1]
    oh = (idx[..., None] == jnp.arange(n, dtype=idx.dtype)).astype(
        jnp.bfloat16)                        # (B, M, N); 0/1 exact in bf16
    out = jnp.einsum("bmn,bnc->bmc", oh, values.astype(jnp.float32),
                     precision=jax.lax.Precision.HIGHEST)
    return out.astype(values.dtype) if values.dtype != jnp.float32 else out
