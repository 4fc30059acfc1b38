"""Floating-point error-bound helpers for watertight intersection.

Counterpart of the reference's numeric-precision utilities
(reference: src/precision.cuh:18-70).  All constants are plain IEEE-754
float32 facts, used to pad AABBs and conservatively bound triangle-test
edge functions so rays cannot leak through shared edges.

Module-level constants are pure Python floats (never jnp at import time —
that would trigger device work during import).
"""

from __future__ import annotations

import jax.numpy as jnp

# Machine epsilon for float32 (unit roundoff, 2^-24).
MACHINE_EPSILON = 5.960464477539063e-08


def err_gamma(n: float) -> float:
    """PBRT's gamma(n) = n*eps / (1 - n*eps): bound on relative error after
    n floating-point ops."""
    ne = n * MACHINE_EPSILON
    return ne / (1.0 - ne)


# Precomputed gammas used by the intersectors.
GAMMA3 = err_gamma(3.0)
GAMMA5 = err_gamma(5.0)
GAMMA7 = err_gamma(7.0)


def next_float_up(x):
    """Next representable float32 toward +inf (bit-trick ulp step)."""
    x = jnp.asarray(x, jnp.float32)
    bits = x.view(jnp.int32)
    bits = jnp.where(x >= 0, bits + 1, bits - 1)
    out = bits.view(jnp.float32)
    return jnp.where(x == 0.0, jnp.float32(1e-45), out)


def next_float_down(x):
    x = jnp.asarray(x, jnp.float32)
    bits = x.view(jnp.int32)
    bits = jnp.where(x > 0, bits - 1, bits + 1)
    out = bits.view(jnp.float32)
    return jnp.where(x == 0.0, jnp.float32(-1e-45), out)
