"""Unit tests for ops: morton codes, sorting, scan/CDF, range reductions."""

import jax
import jax.numpy as jnp
import numpy as np

from rtrt_tpu.ops import morton, reduce as red, scan, sort


def _cpu_morton30(p):
    """Straightforward bit-interleave oracle."""
    q = np.clip(p * 1024.0, 0, 1023).astype(np.uint32)
    out = np.zeros(p.shape[:-1], np.uint32)
    for bit in range(10):
        for axis, shift in ((0, 2), (1, 1), (2, 0)):
            out |= ((q[..., axis] >> bit) & 1).astype(np.uint32) << np.uint32(3 * bit + shift)
    return out


def test_morton30_vs_oracle(rng):
    p = rng.uniform(0, 1, (512, 3)).astype(np.float32)
    ours = np.asarray(morton.morton3d_30(jnp.asarray(p)))
    assert (ours == _cpu_morton30(p)).all()


def test_morton_orders_locality():
    # nearby points should share high bits more often than far points
    a = morton.morton3d_30(jnp.array([[0.1, 0.1, 0.1]]))
    b = morton.morton3d_30(jnp.array([[0.101, 0.1, 0.1]]))
    c = morton.morton3d_30(jnp.array([[0.9, 0.9, 0.9]]))
    xa, xb, xc = int(a[0]), int(b[0]), int(c[0])
    assert (xa ^ xb).bit_length() < (xa ^ xc).bit_length()


def test_normalize_to_aabb_degenerate():
    p = jnp.array([[1.0, 2.0, 3.0]])
    lo = jnp.array([[0.0, 2.0, 0.0]])
    hi = jnp.array([[2.0, 2.0, 6.0]])  # degenerate y extent
    u = np.asarray(morton.normalize_to_aabb(p, lo, hi))
    np.testing.assert_allclose(u, [[0.5, 0.5, 0.5]], atol=1e-6)


def test_sort_key_index(rng):
    keys = jnp.asarray(rng.integers(0, 2**32, (4, 256), dtype=np.uint32))
    sk, reorder = sort.sort_key_index(keys)
    np_sk = np.sort(np.asarray(keys), axis=-1)
    assert (np.asarray(sk) == np_sk).all()
    # reorder really gathers the original keys into sorted order
    gathered = np.take_along_axis(np.asarray(keys), np.asarray(reorder), -1)
    assert (gathered == np_sk).all()


def test_sort_padding_goes_last():
    keys = jnp.asarray(np.array([[5, 0xFFFFFFFF, 3, 0xFFFFFFFF]], dtype=np.uint32))
    sk, _ = sort.sort_key_index(keys)
    assert (np.asarray(sk)[0, -2:] == 0xFFFFFFFF).all()


def test_scan_cdf(rng):
    pdf = jnp.asarray(rng.uniform(0, 1, (16, 32)).astype(np.float32))
    cdf, total = scan.pdf_to_cdf(pdf)
    c = np.asarray(cdf)
    assert (np.diff(c, axis=-1) >= -1e-6).all()
    np.testing.assert_allclose(c[..., -1], 1.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(total), np.asarray(pdf).reshape(16, -1).sum(-1), rtol=1e-4)


def test_scan_cdf_zero_density():
    cdf, total = scan.pdf_to_cdf(jnp.zeros((8,)))
    np.testing.assert_allclose(np.asarray(cdf), (np.arange(8) + 1) / 8, atol=1e-6)
    assert float(total) == 0.0


def test_range_minmax_vs_oracle(rng):
    n, c = 256, 3
    lo = jnp.asarray(rng.normal(size=(n, c)).astype(np.float32))
    hi = lo + jnp.asarray(rng.uniform(0, 1, (n, c)).astype(np.float32))
    lo_t, hi_t = red.build_minmax_table(lo, hi)
    first = jnp.asarray(rng.integers(0, n, 128).astype(np.int32))
    length = rng.integers(0, n, 128)
    last = jnp.asarray(np.minimum(np.asarray(first) + length, n - 1).astype(np.int32))
    qlo, qhi = red.range_minmax(lo_t, hi_t, first, last)
    nlo, nhi = np.asarray(lo), np.asarray(hi)
    for k in range(128):
        f, l = int(first[k]), int(last[k])
        np.testing.assert_allclose(np.asarray(qlo)[k], nlo[f:l + 1].min(0), atol=1e-6)
        np.testing.assert_allclose(np.asarray(qhi)[k], nhi[f:l + 1].max(0), atol=1e-6)


def test_segment_sum():
    data = jnp.ones((6, 3))
    ids = jnp.array([0, 0, 1, 2, 2, 2])
    out = np.asarray(red.segment_sum(data, ids, 4))
    np.testing.assert_allclose(out[:, 0], [2, 1, 3, 0])


def test_onehot_permute_exact(rng):
    """One-hot matmul gather == take_along_axis bit-exactly (f32 and i32)."""
    from rtrt_tpu.ops.gather import onehot_permute
    b, n, c = 3, 256, 5
    vals = jnp.asarray(rng.normal(size=(b, n, c)).astype(np.float32) * 1e3)
    idx = jnp.asarray(
        np.stack([rng.permutation(n) for _ in range(b)]).astype(np.int32))
    ref = jnp.take_along_axis(vals, idx[..., None], axis=1)
    got = onehot_permute(vals, idx)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    ints = jnp.asarray(rng.integers(-2**23, 2**23, (b, n, 2)).astype(np.int32))
    ref_i = jnp.take_along_axis(ints, idx[..., None], axis=1)
    got_i = onehot_permute(ints, idx)
    assert got_i.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(got_i), np.asarray(ref_i))
