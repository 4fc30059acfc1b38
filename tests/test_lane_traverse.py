"""GPU per-lane traversal kernel (bvh/lane_traverse.py) vs the XLA wavefront
reference (`traverse.intersect_scene`).

On the CPU the kernel runs through the Pallas interpreter; the lowering
test checks that the same kernel lowers for CUDA.  Tests marked `gpu` run
the compiled kernel and skip where JAX has no GPU (decided inside the
`gpu_device` fixture, never at import).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtrt_tpu.bvh.build import build_scene_bvh
from rtrt_tpu.bvh.lane_traverse import (BLOCK, intersect, intersect_lanes,
                                        trace_route)
from rtrt_tpu.bvh.sah import build_scene_bvh_sah
from rtrt_tpu.bvh.traverse import intersect_scene
from rtrt_tpu.bvh.types import BATCH_SIZE


def _soup(rng, n, spread=6.0, size=0.8):
    c = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    e1 = rng.normal(size=(n, 3)).astype(np.float32) * size
    e2 = rng.normal(size=(n, 3)).astype(np.float32) * size
    return c, c + e1, c + e2


def _batches(v0, v1, v2, num_batches):
    n = v0.shape[0]
    pad = num_batches * BATCH_SIZE - n
    z = np.zeros((pad, 3), np.float32)
    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    stack = lambda a: np.concatenate([a, z]).reshape(
        num_batches, BATCH_SIZE, 3)
    return (stack(v0), stack(v1), stack(v2),
            valid.reshape(num_batches, BATCH_SIZE))


def _rays_at_scene(rng, n, v0, spread=6.0):
    """Rays from outside the soup aimed at random triangles (most hit)."""
    org = rng.uniform(-2 * spread, 2 * spread, (n, 3)).astype(np.float32)
    tgt = v0[rng.integers(0, v0.shape[0], n)]
    d = tgt - org
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(org), jnp.asarray(d.astype(np.float32))


# (tree, leaf_width, n_rays, any_hit, rays)
CASES = {
    "closest_sah_leaf1": ("sah", 1, 192, False, "scene"),
    "closest_sah_leaf8": ("sah", 8, 192, False, "scene"),
    "closest_lbvh_two_level": ("lbvh", 1, 192, False, "scene"),
    "anyhit_under_tmax": ("sah", 8, 192, True, "scene"),
    "ragged_ray_count": ("sah", 8, BLOCK + 13, False, "scene"),
    "all_miss": ("lbvh", 1, 128, False, "away"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_interpret_matches_wavefront(rng, case):
    tree, lw, n, any_hit, kind = CASES[case]
    v0, v1, v2 = _soup(rng, 700)
    bv = _batches(v0, v1, v2, 2)
    if tree == "sah":
        bvh = build_scene_bvh_sah(*bv, leaf_max=lw)
    else:
        bvh = jax.jit(build_scene_bvh)(*(jnp.asarray(a) for a in bv))
        assert bvh.tlas_internal > 0   # two levels: TLAS over 2 BLAS
    org, d = _rays_at_scene(rng, n, v0)
    if kind == "away":
        org = jnp.full((n, 3), 40.0, jnp.float32)
        d = jnp.abs(d)               # all components >= 0: away from the soup
    t_max = None
    if any_hit:
        t_max = jnp.asarray(rng.uniform(2.0, 12.0, n).astype(np.float32))

    ref = jax.jit(lambda b, o, dd, t: intersect_scene(
        b, o, dd, t, any_hit=any_hit, leaf_width=lw))(bvh, org, d, t_max)
    got = intersect_lanes(bvh, org, d, t_max, any_hit=any_hit,
                          leaf_width=lw, interpret=True)

    hits = np.asarray(ref.tri) >= 0
    if kind == "away":
        assert not hits.any()
    else:
        assert hits.mean() > (0.1 if any_hit else 0.3)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if any_hit:
        assert (np.asarray(got.t)[hits] < np.asarray(t_max)[hits]).all()


def test_sharded_dispatch_matches_single(rng, cpu_mesh_devices):
    """`intersect(mesh=...)` runs the kernel per device under shard_map
    (rays row-sharded, tables replicated) with the same results."""
    from rtrt_tpu.parallel.frame_spmd import make_row_mesh

    v0, v1, v2 = _soup(rng, 500)
    bvh = build_scene_bvh_sah(*_batches(v0, v1, v2, 1), leaf_max=8)
    org, d = _rays_at_scene(rng, 4 * 48, v0)
    mesh = make_row_mesh(devices=cpu_mesh_devices[:4])
    one = intersect("kernel", bvh, org, d, leaf_width=8, interpret=True)
    four = jax.jit(lambda b, o, dd: intersect(
        "kernel", b, o, dd, mesh=mesh, leaf_width=8, interpret=True))(
            bvh, org, d)
    for a, b in zip(four, one):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_kernel_lowers_for_cuda(rng):
    """The kernel lowers for CUDA through Triton (no GPU needed): one Triton
    call, and the traversal loop is inside it, not an XLA while loop."""
    v0, v1, v2 = _soup(rng, 300)
    bvh = build_scene_bvh_sah(*_batches(v0, v1, v2, 1), leaf_max=8)
    org, d = _rays_at_scene(rng, 1000, v0)
    for any_hit in (False, True):
        text = jax.jit(lambda b, o, dd: intersect_lanes(
            b, o, dd, any_hit=any_hit, leaf_width=8)).trace(
                bvh, org, d).lower(lowering_platforms=("cuda",)).as_text()
        assert text.count("__gpu$xla.gpu.triton") == 1
        assert "bvh_lane_traverse" in text
        assert "stablehlo.while" not in text


def test_frame_lowers_for_cuda_through_kernel():
    """The whole frame on the kernel route lowers for CUDA with every bounce
    segment's intersect a kernel call and no XLA while loop left."""
    import re
    from functools import partial

    import __graft_entry__ as ge
    from rtrt_tpu.engine.frame import render_frame
    from rtrt_tpu.render.integrator import SEGMENTS

    fn, args = ge.entry()
    static = fn.args[0]._replace(trace="kernel")
    text = jax.jit(partial(render_frame, static)).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    assert len(re.findall(r"call @intersect_lanes(_\d+)?\b", text)) == SEGMENTS
    assert "__gpu$xla.gpu.triton" in text
    assert "stablehlo.while" not in text


@pytest.mark.parametrize("backend,route", [("gpu", "kernel"),
                                           ("cuda", "kernel"),
                                           ("cpu", "xla"),
                                           ("rocm", None)])
def test_trace_route(backend, route):
    if route is None:
        with pytest.raises(RuntimeError, match="no trace route"):
            trace_route(backend)
    else:
        assert trace_route(backend) == route


def test_engine_refuses_unknown_backend(monkeypatch):
    """The Engine takes its route from the backend and raises, instead of
    falling back, where there is none."""
    from rtrt_tpu.engine.engine import Engine
    from rtrt_tpu.utils.config import DynamicResolution, GlobalSettings

    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="no trace route"):
        Engine(GlobalSettings(render_width=64, render_height=36,
                              scene="demo", texture_size=16,
                              dynamic_resolution=DynamicResolution(
                                  enabled=False)))


@pytest.mark.gpu
def test_compiled_kernel_matches_wavefront(rng, gpu_device):
    """On the card: the compiled kernel agrees with the XLA reference."""
    v0, v1, v2 = _soup(rng, 3000, spread=10.0)
    bvh = build_scene_bvh_sah(*_batches(v0, v1, v2, 3), leaf_max=8)
    org, d = _rays_at_scene(rng, 50_000, v0, spread=10.0)
    got = intersect_lanes(bvh, org, d, leaf_width=8)
    ref = jax.jit(lambda b, o, dd: intersect_scene(b, o, dd, leaf_width=8))(
        bvh, org, d)
    gh, rh = np.asarray(got.tri) >= 0, np.asarray(ref.tri) >= 0
    assert (gh != rh).mean() <= 1e-4
    both = gh & rh
    gt, rt = np.asarray(got.t)[both], np.asarray(ref.t)[both]
    assert (np.abs(gt - rt) / rt).max() <= 1e-5
