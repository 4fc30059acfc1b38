"""Two-level BVH traversal as a vectorized wavefront loop.

The plain XLA reference for the reference's stack traversal
(reference: src/traverse.h:107-253 TraverseBvh, src/traverse.cuh:64-226
RaySceneIntersect), and the CPU route of the frame.  Instead of one
divergent SIMT thread per ray, ALL rays step in lockstep through a masked
`lax.while_loop`:

  * every ray holds a packed int32 "current node" + a STACK_DEPTH stack pair
    (entry, t) (reference stack: src/traverse.h:9-86);
  * each iteration fetches one node (12-float child-AABB pair + 2 packed
    children — the AABBCompact amortization of src/geometry.cuh:603) as
    per-component column gathers, runs a pair slab test, and — when children
    are leaves — watertight triangle tests INLINE in the same iteration, so
    leaf entries never consume stack slots or loop trips;
  * pops scan the whole t-stack at once and jump straight to the
    topmost non-pruned entry: t-pruned entries are skipped in ZERO iterations
    (the reference pops/skips one per loop, src/traverse.h:88-105);
  * TLAS->BLAS transitions cost nothing: TLAS leaf children were pre-resolved
    to BLAS roots at build time (see build.py), so the stack only ever holds
    internal nodes.

The loop runs until every lane is done or `max_steps` (reference cap 1024,
src/traverse.h:132; one of our iterations does strictly more work than one
reference iteration).  Worst-lane dominance is the known cost of lockstep
traversal; on the GPU the per-lane kernel (bvh/lane_traverse.py) runs the
same loop body with lockstep confined to one block of rays.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.geometry import (RAY_TMIN, make_ray_aux,
                             ray_triangle_watertight)
from ..core.precision import GAMMA3
from .types import (BATCH_SIZE, BLAS_NODES, ENTRY_INVALID, GROUP, STACK_DEPTH,
                    MAX_TRAVERSAL_STEPS, SceneBvh, entry_batch, entry_idx,
                    entry_is_blas, entry_is_leaf)


class Hit(NamedTuple):
    """Closest-hit result (sorted-order triangle ids; -1 = miss)."""

    t: jnp.ndarray        # (N,) f32, +inf on miss
    tri: jnp.ndarray      # (N,) i32 sorted triangle id, -1 on miss
    u: jnp.ndarray        # (N,) barycentric of v1
    v: jnp.ndarray        # (N,) barycentric of v2


def _sel3(k, x, y, z):
    """Component select by axis index k in {0,1,2}: all (N,) scalars."""
    return jnp.where(k == 0, x, jnp.where(k == 1, y, z))


# Rays per lockstep while loop.  Larger ray sets are split into chunks
# traced one after another (unrolled, so each chunk's loop ends with its own
# worst lane).  Swept on an H100 at 1080p (PERF.md): 131072-ray chunks trace
# 2.4x faster than 1M-ray chunks but compile ~40x longer (16 loops per
# call), so the reference keeps 1M-ray chunks: two loops per 1080p segment.
TRAVERSAL_CHUNK = 1 << 20


def intersect_scene(bvh: SceneBvh, org, dir, t_max=None, *, any_hit=False,
                    leaf_width=1, max_steps=MAX_TRAVERSAL_STEPS,
                    chunk=TRAVERSAL_CHUNK) -> Hit:
    """Trace rays against the scene.  org/dir: (N,3); t_max: (N,) or None.

    With any_hit=True the loop terminates a lane at its first accepted hit
    (shadow-ray occlusion; t/tri then report that hit, not the closest).
    chunk: rays per lockstep loop (see TRAVERSAL_CHUNK).
    """
    n = org.shape[0]
    if t_max is None:
        t_max = jnp.full((n,), jnp.inf, jnp.float32)
    if n <= chunk:
        return _intersect_chunk(bvh, org, dir, t_max, any_hit, max_steps,
                                leaf_width)

    c = chunk
    pad = (-n) % c
    if pad:
        org = jnp.concatenate([org, jnp.zeros((pad, 3), org.dtype)])
        dir = jnp.concatenate([dir, jnp.tile(jnp.array([[1.0, 0.0, 0.0]],
                                                       dir.dtype), (pad, 1))])
        t_max = jnp.concatenate([t_max, jnp.zeros((pad,), t_max.dtype)])
    nc = org.shape[0] // c
    # unrolled python loop: each chunk's while loop runs only as long as
    # its own worst lane
    parts = [_intersect_chunk(bvh, org[i * c:(i + 1) * c],
                              dir[i * c:(i + 1) * c],
                              t_max[i * c:(i + 1) * c], any_hit, max_steps,
                              leaf_width)
             for i in range(nc)]
    return Hit(*(jnp.concatenate(f)[:n] for f in zip(*parts)))


def _intersect_chunk(bvh: SceneBvh, org, dir, t_max, any_hit,
                     max_steps, leaf_width=1) -> Hit:
    """One lockstep traversal chunk.

    The loop body is written in component form: every quantity is an (N,)
    array, the slab and watertight tests work on scalar components, and
    node/triangle fetches are per-component column gathers from the
    column-major tables (see SceneBvh layout note).  bvh/lane_traverse.py
    repeats this body per lane, operation for operation.
    """
    n = org.shape[0]
    aux = make_ray_aux(dir)
    tlas_internal = bvh.tlas_internal

    # per-ray loop-invariant scalars
    ox, oy, oz = org[:, 0], org[:, 1], org[:, 2]
    ix, iy, iz = aux.inv_dir[:, 0], aux.inv_dir[:, 1], aux.inv_dir[:, 2]
    kx, ky, kz = aux.kx, aux.ky, aux.kz
    sx, sy, sz = aux.sx, aux.sy, aux.sz
    neg_x, neg_y, neg_z = ix < 0.0, iy < 0.0, iz < 0.0
    far_scale = jnp.float32(1.0 + 2.0 * GAMMA3)

    slot = jnp.arange(STACK_DEPTH, dtype=jnp.int32)[None, :]  # (1,D)
    root = jnp.zeros((n,), jnp.int32)  # packed TLAS node 0

    def slab_pair(bc, t_maxv):
        """Scalarized dual slab test on 12 gathered box components."""
        def one(lo0, lo1, lo2, hi0, hi1, hi2):
            nx = jnp.where(neg_x, hi0, lo0)
            fx = jnp.where(neg_x, lo0, hi0)
            ny = jnp.where(neg_y, hi1, lo1)
            fy = jnp.where(neg_y, lo1, hi1)
            nz = jnp.where(neg_z, hi2, lo2)
            fz = jnp.where(neg_z, lo2, hi2)
            tn = jnp.maximum(jnp.maximum((nx - ox) * ix, (ny - oy) * iy),
                             (nz - oz) * iz)
            tf = jnp.minimum(jnp.minimum((fx - ox) * ix, (fy - oy) * iy),
                             (fz - oz) * iz) * far_scale
            hit = (tn <= tf) & (tf > RAY_TMIN) & (tn < t_maxv)
            return hit, jnp.maximum(tn, RAY_TMIN)

        hl, tl = one(bc[0], bc[1], bc[2], bc[3], bc[4], bc[5])
        hr, tr = one(bc[6], bc[7], bc[8], bc[9], bc[10], bc[11])
        return hl, tl, hr, tr

    def tri_test(tc, t_maxv):
        """Scalarized watertight Woop-Benthin-Wald test on 9 gathered
        vertex components."""
        # translate + permute each vertex into ray space (component selects)
        def prep(c0, c1, c2):
            px = c0 - ox
            py = c1 - oy
            pz = c2 - oz
            return (_sel3(kx, px, py, pz), _sel3(ky, px, py, pz),
                    _sel3(kz, px, py, pz))

        axx, axy, axz = prep(tc[0], tc[1], tc[2])
        bxx, bxy, bxz = prep(tc[3], tc[4], tc[5])
        cxx, cxy, cxz = prep(tc[6], tc[7], tc[8])
        ax = axx - sx * axz
        ay = axy - sy * axz
        bx = bxx - sx * bxz
        by = bxy - sy * bxz
        cx = cxx - sx * cxz
        cy = cxy - sy * cxz
        u = cx * by - cy * bx
        v = ax * cy - ay * cx
        w = bx * ay - by * ax
        same = ((u >= 0) & (v >= 0) & (w >= 0)) | ((u <= 0) & (v <= 0) & (w <= 0))
        det = u + v + w
        t_scaled = u * (sz * axz) + v * (sz * bxz) + w * (sz * cxz)
        ts = t_scaled * jnp.sign(det)
        absdet = jnp.abs(det)
        in_range = (ts > RAY_TMIN * absdet) & (ts < t_maxv * absdet)
        hit = same & (det != 0.0) & in_range
        inv_det = jnp.where(det != 0.0, 1.0 / det, 0.0)
        return hit, t_scaled * inv_det, v * inv_det, w * inv_det

    init = dict(
        cur=root,
        sp=jnp.zeros((n,), jnp.int32),
        istack=jnp.full((n, STACK_DEPTH), ENTRY_INVALID, jnp.int32),
        tstack=jnp.full((n, STACK_DEPTH), jnp.inf, jnp.float32),
        best_t=t_max.astype(jnp.float32),
        best_tri=jnp.full((n,), -1, jnp.int32),
        best_u=jnp.zeros((n,), jnp.float32),
        best_v=jnp.zeros((n,), jnp.float32),
        steps=jnp.int32(0),
    )

    def cond(s):
        alive = (s["cur"] != ENTRY_INVALID) | (s["sp"] > 0)
        return (s["steps"] < max_steps) & jnp.any(alive)

    def body(s):
        cur = s["cur"]
        best_t = s["best_t"]
        best_tri = s["best_tri"]
        best_u = s["best_u"]
        best_v = s["best_v"]
        valid = cur != ENTRY_INVALID

        # ---- fetch node row (the stack holds internal nodes only) ----
        blas = entry_is_blas(cur)
        idx = entry_idx(cur)
        batch = entry_batch(cur)
        # non-BLAS rows use the full 22-bit idx|batch field: TLAS nodes
        # carry batch == 0 (row == idx); flat SAH trees use it as the whole
        # node id (bvh/sah.py)
        row = jnp.where(blas, tlas_internal + batch * BLAS_NODES + idx,
                        cur & jnp.int32((1 << 22) - 1))
        row = jnp.where(valid, row, 0)
        # per-component column gathers (native lane layout, no transposes)
        bc = [bvh.boxes_t[k][row] for k in range(12)]
        le = bvh.children_t[0][row]
        re = bvh.children_t[1][row]

        hl, tl, hr, tr = slab_pair(bc, best_t)
        hl = hl & valid
        hr = hr & valid
        l_leaf = entry_is_leaf(le)
        r_leaf = entry_is_leaf(re)

        # ---- leaf children: watertight triangle tests inline ----
        # a leaf covers GROUP morton-adjacent triangles (types.GROUP);
        # padding slots are degenerate (det == 0) and can never hit
        for child, chit, cleaf in ((le, hl, l_leaf), (re, hr, r_leaf)):
            do = chit & cleaf
            tri_base = entry_batch(child) * BATCH_SIZE \
                + entry_idx(child) * GROUP
            # row-aligned multi-tri leaves (flat SAH leaf_max>1 trees);
            # pad slots duplicate the leaf's first triangle — harmless
            for k in range(max(leaf_width, GROUP)):
                tri_idx = tri_base + k
                g = jnp.where(do, tri_idx, 0)
                tc = [bvh.tris_t[c][g] for c in range(9)]  # component gathers
                thit, tt, tu, tv = tri_test(tc, best_t)
                better = do & thit & (tt < best_t)
                best_t = jnp.where(better, tt, best_t)
                best_tri = jnp.where(better, tri_idx, best_tri)
                best_u = jnp.where(better, tu, best_u)
                best_v = jnp.where(better, tv, best_v)

        # ---- internal children: near-first descent, far pushed ----
        lh = hl & ~l_leaf
        rh = hr & ~r_leaf
        both = lh & rh
        near_is_l = tl <= tr
        near_e = jnp.where(near_is_l, le, re)
        far_e = jnp.where(near_is_l, re, le)
        far_t = jnp.maximum(tl, tr)

        push = both & (s["sp"] < STACK_DEPTH)  # overflow: drop far child
        onehot = push[:, None] & (slot == s["sp"][:, None])
        istack = jnp.where(onehot, far_e[:, None], s["istack"])
        tstack = jnp.where(onehot, far_t[:, None], s["tstack"])
        sp = s["sp"] + push.astype(jnp.int32)

        nxt = jnp.where(both, near_e,
                        jnp.where(lh, le, jnp.where(rh, re, ENTRY_INVALID)))

        if any_hit:
            found = best_tri >= 0
            nxt = jnp.where(found, ENTRY_INVALID, nxt)
            sp = jnp.where(found, 0, sp)

        # ---- t-pruned pop: jump straight to the topmost live entry ----
        need_pop = (nxt == ENTRY_INVALID) & (sp > 0)
        live = (slot < sp[:, None]) & (tstack < best_t[:, None])  # (N,D)
        top = jnp.max(jnp.where(live, slot + 1, 0), axis=1)  # 0 = stack empty
        sp2 = jnp.maximum(top - 1, 0)
        popped_e = jnp.take_along_axis(istack, sp2[:, None], axis=1)[:, 0]
        accept = need_pop & (top > 0)
        nxt = jnp.where(accept, popped_e, nxt)
        sp = jnp.where(need_pop, jnp.where(top > 0, sp2, 0), sp)

        return dict(cur=nxt, sp=sp, istack=istack, tstack=tstack,
                    best_t=best_t, best_tri=best_tri, best_u=best_u,
                    best_v=best_v, steps=s["steps"] + 1)

    out = jax.lax.while_loop(cond, body, init)
    miss = out["best_tri"] < 0
    return Hit(jnp.where(miss, jnp.inf, out["best_t"]), out["best_tri"],
               out["best_u"], out["best_v"])


def occluded(bvh: SceneBvh, org, dir, t_max, max_steps=MAX_TRAVERSAL_STEPS):
    """Any-hit occlusion query: True where a blocker exists within t_max."""
    h = intersect_scene(bvh, org, dir, t_max, any_hit=True, max_steps=max_steps)
    return h.tri >= 0


def intersect_brute(org, dir, v0, v1, v2, valid=None, t_max=None) -> Hit:
    """O(N_rays * N_tris) closest-hit oracle for tests (uses the same
    watertight test so results are bit-comparable)."""
    n = org.shape[0]
    aux = make_ray_aux(dir)
    if t_max is None:
        t_max = jnp.full((n,), jnp.inf, jnp.float32)

    th = ray_triangle_watertight(
        org[:, None, :],
        jax.tree_util.tree_map(
            lambda x: x[:, None] if x.ndim == 1 else x[:, None, :], aux),
        v0[None], v1[None], v2[None], RAY_TMIN, t_max[:, None])
    t = th.t
    if valid is not None:
        t = jnp.where(valid[None, :], t, jnp.inf)
    best = jnp.argmin(t, axis=1).astype(jnp.int32)
    bt = jnp.take_along_axis(t, best[:, None], 1)[:, 0]
    miss = ~jnp.isfinite(bt)
    bu = jnp.take_along_axis(th.u, best[:, None], 1)[:, 0]
    bv = jnp.take_along_axis(th.v, best[:, None], 1)[:, 0]
    return Hit(jnp.where(miss, jnp.inf, bt), jnp.where(miss, -1, best), bu, bv)
