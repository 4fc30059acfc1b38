"""Per-frame BVH refit for animated geometry (library code).

The reference rebuilds its two-level morton LBVH from scratch every frame
(reference: src/bvh.cu:7-97).  A full rebuild costs both build time (sorts
+ Karras searches) AND tree quality (a morton tree visits more nodes per
ray than the init-time binned SAH tree).  The alternative for animated
geometry is REFIT: build the high-quality SAH tree ONCE at init over the
undisplaced geometry, then per frame

  * displace the SORTED triangle table directly — for procedural
    displacements (the reference's MeshDisplace hook, src/kernel.cu:139-217)
    this is pure row math on the (9, P) table, ZERO gathers;
  * recompute the row-aligned leaf AABBs with one reshape-reduce;
  * refit internal 4-wide nodes LEVEL-SYNCHRONOUSLY bottom-up: per level,
    every node takes min/max over its (static-index) children's boxes.
    No atomics (the reference's atomicCAS rendezvous, buildBVH.cuh:232-258,
    has no counterpart here and needs none).

Topology is frozen, so boxes grow slightly as geometry moves away from its
rest pose — the classic quality/speed trade of refit — but the SAH split
structure survives bounded displacements far better than a fresh morton
tree.  It emits a 4-wide node table (sah.bvh4_nodes layout); no traversal
reads that layout today, so the Engine's animated scenes take the in-jit
LBVH rebuild (ROADMAP: a 4-wide GPU traversal would feed this).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

_LEAF_BIT = 1 << 23


class RefitPlan(NamedTuple):
    """Static refit schedule for a 4-wide flat SAH tree (host numpy —
    traced into the frame program as constants).

    Per level ℓ (leaf-most first), arrays of shape (k_ℓ, 4):
      idx:    (k_ℓ,)  node ids at this level
      cleaf:  child slot is a leaf
      cempty: child slot is empty (inverted box)
      clidx:  leaf index (slot_base // leaf_width) for leaf children
      cnode:  node id for internal children
    """

    levels: tuple
    entries_f32: np.ndarray   # (q, 4) static child entries as exact f32
    q: int
    n_leaves: int
    leaf_width: int


def plan_refit4(nodes4_raw: np.ndarray, leaf_width: int = 8) -> RefitPlan:
    """Build the level-synchronous schedule from a raw (q, 32) 4-wide node
    table (bvh/sah.py::bvh4_nodes output, BEFORE row packing)."""
    q = nodes4_raw.shape[0]
    ent = nodes4_raw[:, 24:28].astype(np.int64)   # exact: entries < 2^24
    cempty = ent < 0
    cleaf = ((ent & _LEAF_BIT) != 0) & ~cempty
    cint = ~cempty & ~cleaf
    slot = ((ent >> 11) & 0x7FF) * 1024 + (ent & 0x7FF)
    clidx = np.where(cleaf, slot // leaf_width, 0).astype(np.int32)
    cnode = np.where(cint, ent & 0x3FFFFF, 0).astype(np.int32)

    # children always have larger ids than their parent (DFS pop order in
    # the collapse) — one reverse pass assigns bottom-up levels
    level = np.zeros(q, np.int32)
    for i in range(q - 1, -1, -1):
        lv = 0
        for c in range(4):
            if cint[i, c]:
                lv = max(lv, level[cnode[i, c]] + 1)
        level[i] = lv

    levels = []
    for lv in range(int(level.max()) + 1):
        idx = np.nonzero(level == lv)[0].astype(np.int32)
        levels.append((idx, cleaf[idx], cempty[idx], clidx[idx], cnode[idx]))

    n_leaves = int(slot[cleaf].max() // leaf_width) + 1 if cleaf.any() else 0
    return RefitPlan(levels=tuple(levels),
                     entries_f32=nodes4_raw[:, 24:28].astype(np.float32),
                     q=q, n_leaves=n_leaves, leaf_width=leaf_width)


def leaf_bounds(tris_t, n_leaves: int, leaf_width: int = 8):
    """Row-aligned leaf AABBs from the sorted (9, P) triangle table.
    Returns (leaf_lo, leaf_hi), each (n_leaves, 3).  Pure reshape-reduce —
    no gathers (leaves cover slots [0, n_leaves * leaf_width) contiguously;
    short leaves carry duplicate triangles, which are harmless here)."""
    import jax.numpy as jnp

    nv = n_leaves * leaf_width
    los, his = [], []
    for k in range(3):
        c = jnp.stack([tris_t[k, :nv], tris_t[k + 3, :nv],
                       tris_t[k + 6, :nv]])            # (3, nv)
        los.append(c.min(axis=0).reshape(n_leaves, leaf_width).min(axis=1))
        his.append(c.max(axis=0).reshape(n_leaves, leaf_width).max(axis=1))
    return jnp.stack(los, axis=1), jnp.stack(his, axis=1)


def refit_nodes4(plan: RefitPlan, leaf_lo, leaf_hi):
    """Level-synchronous bottom-up refit: returns the refitted raw (q, 32)
    node table (sah.bvh4_nodes layout).

    All indices are static (baked from the frozen topology), so the child
    box fetches are constant-index gathers over tiny arrays and each level
    is one masked min/max + one static scatter."""
    import jax.numpy as jnp

    q = plan.q
    out = jnp.zeros((q, 32), jnp.float32)
    nlo = jnp.full((q, 3), jnp.inf, jnp.float32)
    nhi = jnp.full((q, 3), -jnp.inf, jnp.float32)
    for idx, cleaf, cempty, clidx, cnode in plan.levels:
        rows = []
        box_lo = jnp.full((idx.shape[0], 3), jnp.inf, jnp.float32)
        box_hi = jnp.full((idx.shape[0], 3), -jnp.inf, jnp.float32)
        for c in range(4):
            clo = jnp.where(cleaf[:, c:c + 1], leaf_lo[clidx[:, c]],
                            nlo[cnode[:, c]])
            chi = jnp.where(cleaf[:, c:c + 1], leaf_hi[clidx[:, c]],
                            nhi[cnode[:, c]])
            # empty slots keep inverted boxes (identity under min/max and
            # mins to +inf in the kernel's slab test)
            clo = jnp.where(cempty[:, c:c + 1], jnp.inf, clo)
            chi = jnp.where(cempty[:, c:c + 1], -jnp.inf, chi)
            rows.append(jnp.concatenate([clo, chi], axis=1))   # (k, 6)
            box_lo = jnp.minimum(box_lo, clo)
            box_hi = jnp.maximum(box_hi, chi)
        level_rows = jnp.concatenate(
            rows + [jnp.asarray(plan.entries_f32[idx]),
                    jnp.zeros((idx.shape[0], 4), jnp.float32)], axis=1)
        out = out.at[idx].set(level_rows)
        nlo = nlo.at[idx].set(box_lo)
        nhi = nhi.at[idx].set(box_hi)
    return out
