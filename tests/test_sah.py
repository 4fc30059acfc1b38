"""Flat binned-SAH BVH (bvh/sah.py): oracle correctness + tree validity.

Mirrors the LBVH property tests (test_bvh.py): closest hit through the SAH
tree must equal brute force over all triangles, for both the wavefront
traverser and the GPU lane kernel (interpret mode).  Also checks the tree is
a well-formed binary tree (every leaf reachable exactly once, child boxes
contain their subtrees) and that the native C++ builder agrees with the
numpy fallback on tree quality.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rtrt_tpu.bvh.sah import _sah_fallback, build_scene_bvh_sah
from rtrt_tpu.bvh.traverse import intersect_brute, intersect_scene
from rtrt_tpu.bvh.types import BATCH_SIZE

_LEAF = 1 << 23


def _random_tri_soup(rng, n, spread=10.0, size=0.8):
    c = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    e1 = rng.normal(size=(n, 3)).astype(np.float32) * size
    e2 = rng.normal(size=(n, 3)).astype(np.float32) * size
    return c, c + e1, c + e2


def _pad_batches(v0, v1, v2, num_batches):
    n = v0.shape[0]
    pad = num_batches * BATCH_SIZE - n
    z = np.zeros((pad, 3), np.float32)
    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    stack = lambda a: np.concatenate([a, z]).reshape(
        num_batches, BATCH_SIZE, 3)
    return (stack(v0), stack(v1), stack(v2),
            valid.reshape(num_batches, BATCH_SIZE))


def _normalize(d):
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _tree_valid(boxes, children, n):
    """Every leaf slot reached exactly once; child boxes cover subtrees."""
    m = boxes.shape[0]
    assert m == n - 1
    seen = np.zeros(n, np.int32)
    visits = [0]

    def walk(node, lo, hi):
        visits[0] += 1
        assert visits[0] <= 4 * n, "cycle or malformed tree"
        for side in (0, 1):
            e = int(children[node, side])
            blo = boxes[node, 6 * side:6 * side + 3]
            bhi = boxes[node, 6 * side + 3:6 * side + 6]
            assert (blo >= lo - 1e-4).all() and (bhi <= hi + 1e-4).all(), \
                "child box escapes parent"
            if e & _LEAF:
                slot = ((e >> 11) & 0x7FF) * 1024 + (e & 0x7FF)
                seen[slot] += 1
            else:
                walk(e & 0x3FFFFF, blo, bhi)

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(10000)
    try:
        walk(0, np.full(3, -np.inf), np.full(3, np.inf))
    finally:
        sys.setrecursionlimit(old)
    assert (seen == 1).all(), "leaf coverage broken"


def test_fallback_tree_is_valid(rng):
    v0, v1, v2 = _random_tri_soup(rng, 257)
    soup = np.concatenate([v0, v1, v2], axis=1)
    boxes, children, perm = _sah_fallback(soup)
    _tree_valid(boxes, children, 257)
    assert sorted(perm.tolist()) == list(range(257))


def test_native_tree_is_valid(rng):
    from rtrt_tpu.content import native
    if not native.available():
        pytest.skip("librtrt_native.so not built")
    v0, v1, v2 = _random_tri_soup(rng, 513)
    soup = np.concatenate([v0, v1, v2], axis=1)
    boxes, children, perm = native.build_sah(soup)
    _tree_valid(boxes, children, 513)
    assert sorted(perm.tolist()) == list(range(513))


def test_sah_closest_hit_vs_brute(rng):
    v0, v1, v2 = _random_tri_soup(rng, 700)
    bv0, bv1, bv2, valid = _pad_batches(v0, v1, v2, 2)
    bvh = build_scene_bvh_sah(bv0, bv1, bv2, valid)

    nrays = 512
    org = jnp.asarray(rng.uniform(-15, 15, (nrays, 3)).astype(np.float32))
    dirs = jnp.asarray(_normalize(
        rng.normal(size=(nrays, 3)).astype(np.float32)))

    hit = jax.jit(lambda b, o, d: intersect_scene(b, o, d, max_steps=16384))(
        bvh, org, dirs)
    valid_sorted = np.asarray(valid.reshape(-1))[
        np.asarray(bvh.sorted_tri_index)]
    # padding slots permute to the tail; their sorted_tri_index is 0 but
    # their geometry is degenerate — mask them out of the brute oracle
    valid_sorted[700:] = False
    brute = intersect_brute(org, dirs, bvh.tri_v0, bvh.tri_v1, bvh.tri_v2,
                            valid=jnp.asarray(valid_sorted))

    ht, bt = np.asarray(hit.t), np.asarray(brute.t)
    both_hit = np.isfinite(ht) & np.isfinite(bt)
    same_miss = ~np.isfinite(ht) & ~np.isfinite(bt)
    assert (both_hit | same_miss).mean() > 0.999
    np.testing.assert_allclose(ht[both_hit], bt[both_hit], rtol=1e-4,
                               atol=1e-4)


def test_sah_tables_match_engine_contract(rng):
    """build_scene_tables_sah returns attribute tables aligned with the
    sorted leaf order (normals/materials follow the permutation)."""
    from rtrt_tpu.bvh.sah import build_scene_tables_sah

    v0, v1, v2 = _random_tri_soup(rng, 100)
    # build an indexed mesh: 300 unique verts
    verts = np.concatenate([v0, v1, v2], axis=0).astype(np.float32)
    indices = np.stack([np.arange(100), np.arange(100) + 100,
                        np.arange(100) + 200], axis=1).astype(np.int32)
    pad = 2 * BATCH_SIZE - 100
    indices = np.concatenate([indices, np.zeros((pad, 3), np.int32)])
    tri_mat = np.concatenate([np.arange(100, dtype=np.int32) % 5,
                              np.zeros(pad, np.int32)])
    valid = np.concatenate([np.ones(100, bool), np.zeros(pad, bool)])
    valid = valid.reshape(2, BATCH_SIZE)
    nrm = _normalize(np.ones_like(verts) + verts)

    bvh, tri_nrm_t, sorted_mat = build_scene_tables_sah(
        2, indices, tri_mat, valid, verts, nrm)
    sort_idx = np.asarray(bvh.sorted_tri_index)
    # materials follow the permutation
    np.testing.assert_array_equal(np.asarray(sorted_mat)[:100],
                                  tri_mat[sort_idx[:100]])
    # normals: column k of tri_nrm_t row block 0..2 = nrm of vertex 0
    expect = nrm[indices[sort_idx[:100], 0]].T
    np.testing.assert_allclose(np.asarray(tri_nrm_t)[0:3, :100], expect,
                               rtol=1e-6)


@pytest.mark.slow
def test_sah4_collapse_covers_every_leaf(rng):
    """The 4-wide collapse of the SAH tree (library code for a future
    4-wide traversal and the refit path): native and numpy collapses are
    both valid 4-ary trees covering every leaf once."""
    from rtrt_tpu.bvh.sah import _collapse4_np, bvh4_nodes

    v0, v1, v2 = _random_tri_soup(rng, 300, spread=6.0)
    bv0, bv1, bv2, valid = _pad_batches(v0, v1, v2, 2)
    bvh = build_scene_bvh_sah(bv0, bv1, bv2, valid)
    nodes4 = bvh4_nodes(bvh)
    np4 = _collapse4_np(np.asarray(bvh.boxes_t).T.copy(),
                        np.asarray(bvh.children_t).T.copy())
    for arr in (nodes4, np4):
        seen = np.zeros(300, np.int32)
        stack = [0]
        while stack:
            rec = arr[stack.pop()]
            for k in range(4):
                e = int(rec[24 + k])
                if e < 0:
                    continue
                if e & _LEAF:
                    slot = ((e >> 11) & 0x7FF) * 1024 + (e & 0x7FF)
                    seen[slot] += 1
                else:
                    stack.append(e & 0x3FFFFF)
        assert (seen == 1).all()


@pytest.mark.parametrize("lw", [8, pytest.param(16, marks=pytest.mark.slow),
                                pytest.param(32, marks=pytest.mark.slow)])
@pytest.mark.slow
def test_sah_wide_leaves_all_traversals(rng, lw):
    """Row-aligned multi-tri leaves (leaf_max=8/16/32): the wavefront
    traversal and the GPU lane kernel (interpret mode) match brute force
    over the original soup.  Also: the collapse covers every original
    triangle and pads short leaves with duplicates of a leaf member.
    (RTRT_LEAF_WIDTH selects the width.)"""
    from rtrt_tpu.bvh.lane_traverse import intersect_lanes
    from rtrt_tpu.bvh.traverse import intersect_brute

    v0, v1, v2 = _random_tri_soup(rng, 500, spread=8.0)
    bv0, bv1, bv2, valid = _pad_batches(v0, v1, v2, 1)
    bvh = build_scene_bvh_sah(bv0, bv1, bv2, valid, leaf_max=lw)

    # structure: tree shrank well below n-1 internal nodes; every original
    # triangle is present in the padded sorted table
    assert bvh.boxes_t.shape[1] < 500 // 3
    sti = np.asarray(bvh.sorted_tri_index)
    covered = np.unique(sti[np.asarray(bvh.tris_t)[0] != 0.0])
    assert np.isin(np.arange(500), sti).all()

    org = jnp.asarray(rng.uniform(-15, 15, (256, 3)).astype(np.float32))
    d = jnp.asarray(_normalize(rng.normal(size=(256, 3)).astype(np.float32)))

    hb = intersect_brute(org, d, jnp.asarray(v0), jnp.asarray(v1),
                         jnp.asarray(v2))
    tb = np.asarray(hb.t)

    hw = intersect_scene(bvh, org, d, leaf_width=lw, max_steps=16384)
    hk = intersect_lanes(bvh, org, d, leaf_width=lw, max_steps=16384,
                         interpret=True)

    for t in (np.asarray(hw.t), np.asarray(hk.t)):
        assert (np.isfinite(t) == np.isfinite(tb)).all()
        m = np.isfinite(t)
        np.testing.assert_allclose(t[m], tb[m], rtol=1e-4, atol=1e-4)
