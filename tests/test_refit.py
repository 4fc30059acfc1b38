"""Per-frame BVH refit (bvh/refit.py): oracle correctness.

The refit path freezes the init-time SAH/BVH4 topology and recomputes all
boxes per frame from the displaced sorted triangle table.  Checks:
  * refit at the rest pose reproduces the builder's boxes exactly;
  * after displacement, every node box contains its children (validity)
    and the row-form displacement matches the vertex form;
  * the analytic wave normal transform (engine/frame.py::wave_normal_rows)
    matches a numerical tangent-frame recompute.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rtrt_tpu.bvh.refit import leaf_bounds, plan_refit4, refit_nodes4
from rtrt_tpu.bvh.sah import build_scene_bvh_sah, bvh4_nodes
from rtrt_tpu.bvh.types import BATCH_SIZE
from rtrt_tpu.engine.frame import (displace_wave, displace_wave_rows,
                                   wave_normal_rows)

_LEAF = 1 << 23


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _soup(rng, n, spread=8.0, size=0.7):
    c = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    e1 = rng.normal(size=(n, 3)).astype(np.float32) * size
    e2 = rng.normal(size=(n, 3)).astype(np.float32) * size
    return c, c + e1, c + e2


def _pad(v0, v1, v2, b=1):
    n = v0.shape[0]
    pad = b * BATCH_SIZE - n
    z = np.zeros((pad, 3), np.float32)
    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    st = lambda a: np.concatenate([a, z]).reshape(b, BATCH_SIZE, 3)
    return st(v0), st(v1), st(v2), valid.reshape(b, BATCH_SIZE)


def _build(rng, n=500, leaf_max=8):
    v0, v1, v2 = _soup(rng, n)
    bvh = build_scene_bvh_sah(*_pad(v0, v1, v2), leaf_max=leaf_max)
    raw4 = bvh4_nodes(bvh)
    plan = plan_refit4(raw4, leaf_width=leaf_max)
    return bvh, raw4, plan, (v0, v1, v2)


def test_refit_rest_pose_reproduces_builder(rng):
    bvh, raw4, plan, _ = _build(rng)
    llo, lhi = leaf_bounds(bvh.tris_t, plan.n_leaves, plan.leaf_width)
    ref = np.asarray(refit_nodes4(plan, llo, lhi))
    # min/max over the same triangle set — exact agreement expected on
    # non-empty box lanes (empty slots: the native collapse writes ±1e30,
    # refit writes ±inf — both are never-hit sentinels); entry lanes are
    # copied through
    occupied = np.repeat(raw4[:, 24:28] >= 0, 6, axis=1)
    np.testing.assert_allclose(ref[:, :24][occupied], raw4[:, :24][occupied],
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ref[:, 24:28], raw4[:, 24:28])


def _node_boxes_valid(nodes4, leaf_lo, leaf_hi, leaf_width):
    """Every child box equals its subtree's true bounds (recursive)."""
    memo = {}

    def node_bounds(i):
        if i in memo:
            return memo[i]
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)
        rec = nodes4[i]
        for c in range(4):
            e = int(rec[24 + c])
            if e < 0:
                continue
            blo = rec[6 * c:6 * c + 3]
            bhi = rec[6 * c + 3:6 * c + 6]
            if e & _LEAF:
                slot = ((e >> 11) & 0x7FF) * 1024 + (e & 0x7FF)
                li = slot // leaf_width
                np.testing.assert_allclose(blo, leaf_lo[li], atol=1e-5)
                np.testing.assert_allclose(bhi, leaf_hi[li], atol=1e-5)
            else:
                clo, chi = node_bounds(e & 0x3FFFFF)
                np.testing.assert_allclose(blo, clo, atol=1e-5)
                np.testing.assert_allclose(bhi, chi, atol=1e-5)
            lo = np.minimum(lo, blo)
            hi = np.maximum(hi, bhi)
        memo[i] = (lo, hi)
        return memo[i]

    node_bounds(0)


@pytest.mark.slow
def test_refit_displaced_boxes_valid(rng):
    bvh, raw4, plan, _ = _build(rng)
    t_now = jnp.float32(1.7)
    tt = displace_wave_rows(bvh.tris_t, t_now)
    llo, lhi = leaf_bounds(tt, plan.n_leaves, plan.leaf_width)
    refitted = refit_nodes4(plan, llo, lhi)
    _node_boxes_valid(np.asarray(refitted), np.asarray(llo),
                      np.asarray(lhi), plan.leaf_width)

    # displaced tris in sorted order = rows of tt; brute force over them.
    # displace_wave (vertex form) on the same positions must agree with
    # the row form.
    nv = plan.n_leaves * plan.leaf_width
    tt_np = np.asarray(tt)
    dv0 = tt_np[0:3, :nv].T
    dv1 = tt_np[3:6, :nv].T
    dv2 = tt_np[6:9, :nv].T
    t0 = np.asarray(bvh.tris_t)
    for rowbase, dv in ((0, dv0), (3, dv1), (6, dv2)):
        vtx = t0[rowbase:rowbase + 3, :nv].T
        expect = np.asarray(displace_wave(jnp.asarray(vtx), t_now))
        np.testing.assert_allclose(dv, expect, atol=1e-6)


def test_wave_normal_rows_matches_numerical_jacobian(rng):
    """n' from the analytic cofactor transform == normalized cross product
    of numerically displaced tangent vectors."""
    n = 64
    p = rng.uniform(-6, 6, (n, 3)).astype(np.float64)
    # random unit normals + tangent frames
    nm = rng.normal(size=(n, 3))
    nm /= np.linalg.norm(nm, axis=1, keepdims=True)
    t1 = np.cross(nm, np.roll(nm, 1, axis=1) + 0.3)
    t1 /= np.linalg.norm(t1, axis=1, keepdims=True)
    t2 = np.cross(nm, t1)

    t_now = 0.9
    eps = 1e-4

    def disp(q):
        out = np.asarray(displace_wave(jnp.asarray(q.astype(np.float32)),
                                       jnp.float32(t_now))).astype(np.float64)
        return out

    d1 = (disp(p + eps * t1) - disp(p - eps * t1)) / (2 * eps)
    d2 = (disp(p + eps * t2) - disp(p - eps * t2)) / (2 * eps)
    num = np.cross(d1, d2)
    num /= np.linalg.norm(num, axis=1, keepdims=True)

    # analytic transform expects (9, P) rows; feed the frame as "v0" rows
    tris_rows = jnp.asarray(np.tile(p.T.astype(np.float32), (3, 1)))
    nrm_rows = jnp.asarray(np.tile(nm.T.astype(np.float32), (3, 1)))
    out = np.asarray(wave_normal_rows(nrm_rows, tris_rows,
                                      jnp.float32(t_now)))[0:3].T
    # same hemisphere + close direction
    dots = np.abs(np.sum(out * num, axis=1))
    assert (dots > 0.999).all(), dots.min()
