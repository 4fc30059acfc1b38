"""Auto-exposure: log-luminance histogram + eye adaptation.

Counterpart of the reference's exposure pipeline
(reference: Histogram2 via atomicInc at src/postprocessing.cuh:24-39 and the
single-thread AutoExposure kernel :43-136).

Re-architecture: the histogram is a ONE-HOT MATMUL — bucketize the 1/64-res
luminance image, one-hot to (P, 64), sum-reduce.  No atomics.
The "single-thread" adaptation state machine becomes a tiny pure-scalar
update returning new state (EV, adapted lum, bright lum) as a (4,) array,
exactly the reference's 4-float exposure buffer.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.color import luminance

NUM_BINS = 64
LOG_LUM_MIN = -10.0  # log2 range of the histogram
LOG_LUM_MAX = 10.0


def log_luminance_histogram(img_small):
    """(h, w, 3) 1/64-res color -> (NUM_BINS,) normalized histogram."""
    lum = luminance(img_small).reshape(-1)
    ll = jnp.clip((jnp.log2(jnp.maximum(lum, 1e-8)) - LOG_LUM_MIN)
                  / (LOG_LUM_MAX - LOG_LUM_MIN), 0.0, 1.0)
    binf = ll * (NUM_BINS - 1)
    b0 = jnp.floor(binf).astype(jnp.int32)
    # one-hot histogram (replaces atomicInc)
    onehot = (b0[:, None] == jnp.arange(NUM_BINS)[None, :]).astype(jnp.float32)
    hist = jnp.sum(onehot, axis=0)
    return hist / jnp.maximum(jnp.sum(hist), 1.0)


def _percentile_mean_lum(hist, lo=0.4, hi=0.9):
    """Mean log-luminance between the dark/bright percentile cuts
    (reference cuts 40%/90%, postprocessing.cuh:60-90)."""
    cdf = jnp.cumsum(hist)
    prev = cdf - hist
    # mass of each bin clipped to [lo, hi] of the cdf
    clipped = jnp.clip(jnp.minimum(cdf, hi) - jnp.maximum(prev, lo), 0.0, None)
    centers = LOG_LUM_MIN + (jnp.arange(NUM_BINS) + 0.5) \
        / NUM_BINS * (LOG_LUM_MAX - LOG_LUM_MIN)
    mean_ll = jnp.sum(clipped * centers) / jnp.maximum(jnp.sum(clipped), 1e-6)
    # bright-region mean (top decile) for the bloom threshold
    bright = jnp.clip(cdf - 0.9, 0.0, None)
    bmass = jnp.clip(jnp.minimum(cdf, 1.0) - jnp.maximum(prev, 0.9), 0.0, None)
    bright_ll = jnp.sum(bmass * centers) / jnp.maximum(jnp.sum(bmass), 1e-6)
    return 2.0 ** mean_ll, 2.0 ** bright_ll


def exposure_compensation(avg_lum):
    """Scene-key curve: brighter scenes get compressed less
    (the reference's exposure-compensation curve, postprocessing.cuh:95-110)."""
    key = 1.03 - 2.0 / (jnp.log2(avg_lum * 1000.0 + 1.0) + 2.0)
    return key


def init_exposure_state():
    """(4,) = [EV scale, adapted lum, adapted bright lum, initialized]."""
    return jnp.array([1.0, 0.5, 2.0, 0.0], jnp.float32)


def auto_exposure(img_small, state, dt, gain):
    """One adaptation step; returns (new_state,).

    state: (4,) [exposure, adapted_lum, adapted_bright, initialized]
    dt: frame time (s); gain: user exposure gain.
    Eye adaptation: exponential approach 1 - exp(-dt / tau), tau = 1 s
    (reference: postprocessing.cuh:43-136).
    """
    hist = log_luminance_histogram(img_small)
    lum, bright = _percentile_mean_lum(hist)
    initialized = state[3] > 0.5
    a = 1.0 - jnp.exp(-dt / 1.0)
    adapted = jnp.where(initialized, state[1] + (lum - state[1]) * a, lum)
    adapted_b = jnp.where(initialized, state[2] + (bright - state[2]) * a, bright)
    ec = exposure_compensation(adapted)
    ev = gain * ec / jnp.maximum(adapted, 1e-6)
    return jnp.stack([ev, adapted, adapted_b, jnp.float32(1.0)])
