"""Per-lane BVH traversal kernel for NVIDIA GPUs (Pallas through Triton).

The GPU counterpart of `traverse.intersect_scene`, and the reference's own
design (reference: src/traverse.h:107-253 TraverseBvh,
src/traverse.cuh:64-226): one ray per lane, each with its own stack, node
and triangle records fetched by per-lane loads that the card serves from
L1/L2.

Each program instance owns a block of `block` rays and runs one
`lax.while_loop` until every lane of the block is done, so lockstep is
confined to the block and the ray state never leaves registers.  The loop
body is the same arithmetic as `traverse._intersect_chunk`: the same slab
test, watertight triangle test, near-first descent, two-level entry
encoding and whole-stack t-pruned pop, in the same float32 operation
order, so the kernel's hits agree with the XLA reference nearly bit for
bit.  One difference is not arithmetic: a lane whose `t_max` is at most
RAY_TMIN cannot accept any triangle, so it starts dead instead of walking
the tree to find nothing.

The kernel reads the same `SceneBvh` tables as the reference.  Once per
call they are repacked into row-per-record layouts (16 floats per node or
triangle, one 64-byte line each), so a lane's record fetch touches one
cache line instead of one per column.

`trace_route` is the one place that decides, from the JAX backend, which
traversal a frame uses.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core.geometry import make_ray_aux
from ..core.precision import GAMMA3
from .traverse import Hit, intersect_scene
from .types import (BATCH_SIZE, BLAS_NODES, GROUP, MAX_TRAVERSAL_STEPS,
                    STACK_DEPTH, SceneBvh)

# plain Python constants: a Pallas kernel may not close over jax arrays
_TMIN = 1e-4                 # == core.geometry.RAY_TMIN
_INVALID = -1                # == types.ENTRY_INVALID
_LEAF_BIT = 1 << 23
_BLAS_BIT = 1 << 22
_IDX_MASK = (1 << 11) - 1
_ROW = 16                    # floats per packed node / triangle / ray record

# rays per program instance and warps: one warp of 32 rays, one ray per
# thread, so lockstep spans exactly the SIMT warp as in the reference.
# Swept on an H100 (1080p terrain, PERF.md): 32x1 beat 64x2 and 128x4.
BLOCK = 32
NUM_WARPS = 1


def trace_route(backend: str | None = None) -> str:
    """The frame's traversal, from the JAX backend: "kernel" on a GPU,
    "xla" (the wavefront reference) on the CPU.  Any other backend raises:
    nothing falls back quietly."""
    backend = backend or jax.default_backend()
    if backend in ("gpu", "cuda"):
        return "kernel"
    if backend == "cpu":
        return "xla"
    raise RuntimeError(f"no trace route for JAX backend '{backend}' "
                       f"(supported: gpu, cpu)")


def _pack_rows(cols):
    """(k, M) columns -> flat (M * _ROW,) f32 row-per-record table."""
    k, m = cols.shape
    rows = jnp.concatenate([cols.T, jnp.zeros((m, _ROW - k), jnp.float32)],
                           axis=1)
    return rows.reshape(-1)


def pack_tables(bvh: SceneBvh):
    """Row-per-record node and triangle tables for the kernel.

    node row: 12 child-box floats, then the two packed child entries
    (int32 bit patterns); triangle row: v0, v1, v2."""
    children = jax.lax.bitcast_convert_type(bvh.children_t, jnp.float32)
    nodes = _pack_rows(jnp.concatenate([bvh.boxes_t, children], axis=0))
    tris = _pack_rows(bvh.tris_t)
    return nodes, tris


def _pack_rays(org, dir, t_max, n_pad):
    """(16, n_pad) per-ray records: org, inv_dir, shear (sx, sy, sz), the
    permutation axes (int32 bit patterns) and t_max.  Pad lanes get
    t_max = 0 and never run."""
    aux = make_ray_aux(dir)
    bits = lambda k: jax.lax.bitcast_convert_type(k, jnp.float32)
    cols = [org[:, 0], org[:, 1], org[:, 2],
            aux.inv_dir[:, 0], aux.inv_dir[:, 1], aux.inv_dir[:, 2],
            aux.sx, aux.sy, aux.sz, bits(aux.kx), bits(aux.ky), bits(aux.kz),
            t_max.astype(jnp.float32)]
    n = org.shape[0]
    cols += [jnp.zeros((n,), jnp.float32)] * (_ROW - len(cols))
    rays = jnp.stack(cols)
    return jnp.pad(rays, ((0, 0), (0, n_pad - n)))


def _sel3(k, x, y, z):
    return jnp.where(k == 0, x, jnp.where(k == 1, y, z))


def _kernel(ray_ref, nodes_ref, tris_ref, t_ref, tri_ref, u_ref, v_ref, *,
            tlas_internal, leaf_width, any_hit, max_steps, stack_depth):
    r = [ray_ref[k, :] for k in range(13)]
    ox, oy, oz, ix, iy, iz, sx, sy, sz = r[:9]
    kx, ky, kz = (jax.lax.bitcast_convert_type(c, jnp.int32)
                  for c in r[9:12])
    t_max = r[12]
    neg_x, neg_y, neg_z = ix < 0.0, iy < 0.0, iz < 0.0
    far_scale = 1.0 + 2.0 * GAMMA3
    b = ox.shape[0]
    slot = jax.lax.broadcasted_iota(jnp.int32, (b, stack_depth), 1)

    def fetch(ref, row, k):
        return ref[row * _ROW + k]

    def slab(bc, best_t):
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
            hit = (tn <= tf) & (tf > _TMIN) & (tn < best_t)
            return hit, jnp.maximum(tn, _TMIN)

        hl, tl = one(*bc[0:6])
        hr, tr = one(*bc[6:12])
        return hl, tl, hr, tr

    def tri_test(tc, best_t):
        def prep(c0, c1, c2):
            px, py, pz = c0 - ox, c1 - oy, c2 - oz
            return (_sel3(kx, px, py, pz), _sel3(ky, px, py, pz),
                    _sel3(kz, px, py, pz))

        axx, axy, axz = prep(*tc[0:3])
        bxx, bxy, bxz = prep(*tc[3:6])
        cxx, cxy, cxz = prep(*tc[6:9])
        ax = axx - sx * axz
        ay = axy - sy * axz
        bx = bxx - sx * bxz
        by = bxy - sy * bxz
        cx = cxx - sx * cxz
        cy = cxy - sy * cxz
        u = cx * by - cy * bx
        v = ax * cy - ay * cx
        w = bx * ay - by * ax
        same = (((u >= 0) & (v >= 0) & (w >= 0))
                | ((u <= 0) & (v <= 0) & (w <= 0)))
        det = u + v + w
        t_scaled = u * (sz * axz) + v * (sz * bxz) + w * (sz * cxz)
        ts = t_scaled * jnp.sign(det)
        absdet = jnp.abs(det)
        in_range = (ts > _TMIN * absdet) & (ts < best_t * absdet)
        hit = same & (det != 0.0) & in_range
        inv_det = jnp.where(det != 0.0, 1.0 / det, 0.0)
        return hit, t_scaled * inv_det, v * inv_det, w * inv_det

    def alive(s):
        return (s[0] != _INVALID) | (s[1] > 0)

    def cond(s):
        live = jnp.max(alive(s).astype(jnp.int32))
        return (s[-1] < max_steps) & (live > 0)

    def body(s):
        cur, sp, istack, tstack, best_t, best_tri, best_u, best_v, steps = s
        valid = cur != _INVALID
        blas = (cur & _BLAS_BIT) != 0
        idx = cur & _IDX_MASK
        batch = (cur >> 11) & _IDX_MASK
        row = jnp.where(blas, tlas_internal + batch * BLAS_NODES + idx,
                        cur & ((1 << 22) - 1))
        row = jnp.where(valid, row, 0)
        bc = [fetch(nodes_ref, row, k) for k in range(12)]
        le = jax.lax.bitcast_convert_type(fetch(nodes_ref, row, 12),
                                          jnp.int32)
        re = jax.lax.bitcast_convert_type(fetch(nodes_ref, row, 13),
                                          jnp.int32)

        hl, tl, hr, tr = slab(bc, best_t)
        hl = hl & valid
        hr = hr & valid
        l_leaf = (le & _LEAF_BIT) != 0
        r_leaf = (re & _LEAF_BIT) != 0

        for child, chit, cleaf in ((le, hl, l_leaf), (re, hr, r_leaf)):
            do = chit & cleaf
            tri_base = (((child >> 11) & _IDX_MASK) * BATCH_SIZE
                        + (child & _IDX_MASK) * GROUP)
            for k in range(max(leaf_width, GROUP)):
                tri_idx = tri_base + k
                g = jnp.where(do, tri_idx, 0)
                tc = [fetch(tris_ref, g, c) for c in range(9)]
                thit, tt, tu, tv = tri_test(tc, best_t)
                better = do & thit & (tt < best_t)
                best_t = jnp.where(better, tt, best_t)
                best_tri = jnp.where(better, tri_idx, best_tri)
                best_u = jnp.where(better, tu, best_u)
                best_v = jnp.where(better, tv, best_v)

        lh = hl & ~l_leaf
        rh = hr & ~r_leaf
        both = lh & rh
        near_is_l = tl <= tr
        near_e = jnp.where(near_is_l, le, re)
        far_e = jnp.where(near_is_l, re, le)
        far_t = jnp.maximum(tl, tr)

        push = both & (sp < STACK_DEPTH)  # overflow drops the far child
        onehot = push[:, None] & (slot == sp[:, None])
        istack = jnp.where(onehot, far_e[:, None], istack)
        tstack = jnp.where(onehot, far_t[:, None], tstack)
        sp = sp + push.astype(jnp.int32)

        nxt = jnp.where(both, near_e,
                        jnp.where(lh, le, jnp.where(rh, re, _INVALID)))
        if any_hit:
            found = best_tri >= 0
            nxt = jnp.where(found, _INVALID, nxt)
            sp = jnp.where(found, 0, sp)

        need_pop = (nxt == _INVALID) & (sp > 0)
        live = (slot < sp[:, None]) & (tstack < best_t[:, None])
        top = jnp.max(jnp.where(live, slot + 1, 0), axis=1)
        sp2 = jnp.maximum(top - 1, 0)
        popped = jnp.sum(jnp.where(slot == sp2[:, None], istack, 0), axis=1)
        nxt = jnp.where(need_pop & (top > 0), popped, nxt)
        sp = jnp.where(need_pop, sp2, sp)
        return (nxt, sp, istack, tstack, best_t, best_tri, best_u, best_v,
                steps + 1)

    # a lane whose t_max <= RAY_TMIN can accept no triangle: start it dead
    cur = jnp.where(t_max > _TMIN, 0, _INVALID).astype(jnp.int32)
    zi = jnp.zeros((b,), jnp.int32)
    zf = jnp.zeros((b,), jnp.float32)
    init = (cur, zi,
            jnp.full((b, stack_depth), _INVALID, jnp.int32),
            jnp.full((b, stack_depth), jnp.inf, jnp.float32),
            t_max, zi - 1, zf, zf, jnp.int32(0))
    out = jax.lax.while_loop(cond, body, init)
    best_t, best_tri, best_u, best_v = out[4:8]
    t_ref[...] = jnp.where(best_tri < 0, jnp.inf, best_t)
    tri_ref[...] = best_tri
    u_ref[...] = best_u
    v_ref[...] = best_v


@functools.partial(jax.jit, static_argnames=(
    "any_hit", "leaf_width", "max_steps", "block", "num_warps",
    "interpret"))
def intersect_lanes(bvh: SceneBvh, org, dir, t_max=None, *, any_hit=False,
                    leaf_width=1, max_steps=MAX_TRAVERSAL_STEPS,
                    block=BLOCK, num_warps=NUM_WARPS,
                    interpret=False) -> Hit:
    """Drop-in for `traverse.intersect_scene` on the GPU: same tables,
    arguments and `Hit`.  org/dir: (N,3); t_max: (N,) or None.

    interpret=True runs the kernel through the Pallas interpreter (CPU
    tests); nothing else sets it."""
    n = org.shape[0]
    if t_max is None:
        t_max = jnp.full((n,), jnp.inf, jnp.float32)
    n_pad = -(-n // block) * block
    rays = _pack_rays(org, dir, t_max, n_pad)
    nodes, tris = pack_tables(bvh)
    kernel = functools.partial(
        _kernel, tlas_internal=max(0, bvh.tlas_internal),
        leaf_width=leaf_width, any_hit=any_hit, max_steps=max_steps,
        stack_depth=pl.next_power_of_2(STACK_DEPTH))
    lane = pl.BlockSpec((block,), lambda i: (i,))
    t, tri, u, v = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((n_pad,), jnp.float32),
                   jax.ShapeDtypeStruct((n_pad,), jnp.int32),
                   jax.ShapeDtypeStruct((n_pad,), jnp.float32),
                   jax.ShapeDtypeStruct((n_pad,), jnp.float32)),
        grid=(n_pad // block,),
        in_specs=[pl.BlockSpec((_ROW, block), lambda i: (0, i)),
                  pl.no_block_spec, pl.no_block_spec],
        out_specs=(lane, lane, lane, lane),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="bvh_lane_traverse",
    )(rays, nodes, tris)
    return Hit(t[:n], tri[:n], u[:n], v[:n])


def intersect(trace: str, bvh: SceneBvh, org, dir, t_max=None, *,
              mesh=None, **kw) -> Hit:
    """One scene intersect through the frame's traversal route.

    trace: "kernel" (this module's kernel) or "xla" (the wavefront
    reference, `traverse.intersect_scene`).  mesh: optional 1-D device
    mesh whose axis shards the rays; the kernel then runs per device under
    `shard_map` with the tables replicated (GSPMD cannot partition a kernel
    call).  The XLA route needs no wrapping: the partitioner follows the
    frame's row sharding.  kw: any_hit, leaf_width, max_steps."""
    if trace == "xla":
        return intersect_scene(bvh, org, dir, t_max, **kw)
    if trace != "kernel":
        raise ValueError(f"unknown trace route '{trace}'")
    if t_max is None:
        t_max = jnp.full((org.shape[0],), jnp.inf, jnp.float32)
    if mesh is None:
        return intersect_lanes(bvh, org, dir, t_max, **kw)
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    rows = P(mesh.axis_names[0])
    return shard_map(
        lambda b, o, d, t: intersect_lanes(b, o, d, t, **kw), mesh=mesh,
        in_specs=(P(), rows, rows, rows), out_specs=rows,
        check_vma=False)(bvh, org, dir, t_max)
