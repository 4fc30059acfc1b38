"""Prefix sums (scans) and CDF construction.

Counterpart of the reference's two-level Blelloch scan
(reference: src/scan.cuh:32-297, used to turn sky/sun luminance PDFs into
CDFs at src/kernel.cu:298,301).  XLA's `cumsum` compiles to an efficient
parallel scan, so the hand-written shared-memory version collapses
to a one-liner; helpers below add the normalization/flattening used by the
light-sampling code.
"""

from __future__ import annotations

import jax.numpy as jnp


def inclusive_scan(x, axis=-1):
    return jnp.cumsum(x, axis=axis)


def exclusive_scan(x, axis=-1):
    inc = jnp.cumsum(x, axis=axis)
    return inc - x


def pdf_to_cdf(pdf):
    """Inclusive CDF over the LAST axis of a nonnegative density, normalized
    so the last entry is exactly 1 (degenerate all-zero rows become uniform).
    Callers sampling 2D maps flatten H*W into the last axis first.
    Returns (cdf, total) where total is the unnormalized row sum."""
    flat = pdf
    cdf = jnp.cumsum(flat, axis=-1)
    total = cdf[..., -1:]
    n = flat.shape[-1]
    uniform = (jnp.arange(1, n + 1, dtype=jnp.float32) / n)
    uniform = jnp.broadcast_to(uniform, cdf.shape)
    good = total > 0.0
    return jnp.where(good, cdf / jnp.maximum(total, 1e-30), uniform), total[..., 0]
