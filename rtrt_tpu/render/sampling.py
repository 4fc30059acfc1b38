"""Low-discrepancy sampling + geometric warps.

Counterpart of the reference's Heitz-Belcour blue-noise sampler
(reference: src/blueNoiseRandGen.h:75-156 with Sobol/scrambling/ranking data
tables in src/blueNoiseRandGenData.h) and its Wang-hash fallback (:6-29).

Rather than shipping precomputed tiles, we generate samples *in bit math*:
per-pixel progressive Owen-scrambled Sobol (Burley 2020, "Practical
Hash-based Owen Scrambling").  Each pixel gets its own randomized Sobol
sequence indexed by frame number — ideal for 1-spp-per-frame temporal
accumulation — and each sampling dimension is decorrelated by an independent
hash-seeded Owen scramble.  Quality matches table-based samplers for this
use case and the working set is zero bytes.

All functions are pure uint32 bit ops over arbitrary batch shapes.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.vecmath import vec3

U32 = jnp.uint32
TWO_PI = 6.283185307179586
INV_2POW32 = 2.3283064365386963e-10  # 2^-32
INV_2POW24 = 5.960464477539063e-08   # 2^-24


def _u32(x):
    return jnp.asarray(x).astype(U32)


def hash_pcg(x):
    """PCG output permutation — fast per-element hash (uint32 -> uint32)."""
    x = _u32(x)
    state = x * U32(747796405) + U32(2891336453)
    word = ((state >> ((state >> 28) + U32(4))) ^ state) * U32(277803737)
    return (word >> 22) ^ word


def hash_combine(a, b):
    """Combine two uint32 hashes (boost-style mix)."""
    a = _u32(a)
    b = _u32(b)
    return hash_pcg(a ^ (b + U32(0x9E3779B9) + (a << 6) + (a >> 2)))


def wang_hash(x):
    """Wang hash — the reference's fallback RNG (blueNoiseRandGen.h:6-17)."""
    x = _u32(x)
    x = (x ^ U32(61)) ^ (x >> 16)
    x = x * U32(9)
    x = x ^ (x >> 4)
    x = x * U32(0x27D4EB2D)
    x = x ^ (x >> 15)
    return x


def reverse_bits32(x):
    x = _u32(x)
    x = ((x & U32(0x55555555)) << 1) | ((x & U32(0xAAAAAAAA)) >> 1)
    x = ((x & U32(0x33333333)) << 2) | ((x & U32(0xCCCCCCCC)) >> 2)
    x = ((x & U32(0x0F0F0F0F)) << 4) | ((x & U32(0xF0F0F0F0)) >> 4)
    x = ((x & U32(0x00FF00FF)) << 8) | ((x & U32(0xFF00FF00)) >> 8)
    return (x << 16) | (x >> 16)


def _sobol_dim0(index):
    """First Sobol dimension = van der Corput radical inverse."""
    return reverse_bits32(index)


def _sobol_dim1_directions():
    """The 32 direction numbers of Sobol dimension 1 (v_{k+1}=v_k^(v_k>>1))
    as python constants (baked at trace time — no per-call carry chain)."""
    vs = []
    v = 1 << 31
    for _ in range(32):
        vs.append(v)
        v ^= v >> 1
    return vs


_DIM1_V = _sobol_dim1_directions()


def _sobol_dim1(index):
    """Second Sobol dimension: XOR of constant direction numbers selected
    by the index bits."""
    index = _u32(index)
    result = jnp.zeros_like(index)
    for k in range(32):
        bit = (index >> k) & U32(1)
        result = result ^ (bit * U32(_DIM1_V[k]))
    return result


def _laine_karras_permutation(x, seed):
    """Hash whose avalanching only flows from high bits to low bits — applied
    to reversed bits it is a valid Owen scramble (Burley 2020 constants)."""
    x = _u32(x) + _u32(seed)
    x = x ^ (x * U32(0x6C50B47C))
    x = x ^ (x * U32(0xB82F1E52))
    x = x ^ (x * U32(0xC7AFE638))
    x = x ^ (x * U32(0x8D22F6E6))
    return x


def owen_scramble(x, seed):
    return reverse_bits32(_laine_karras_permutation(reverse_bits32(x), seed))


def _to_unit_float(u):
    """uint32 -> [0, 1) float32 via the top 24 bits (exact in f32's
    mantissa; the component-form shading twin shares this code)."""
    return (u >> 8).astype(jnp.int32).astype(jnp.float32) \
        * jnp.float32(INV_2POW24)


def sobol_owen_2d(index, seed):
    """One decorrelated 2D low-discrepancy point per element.

    index: uint32 sample index (frame number for progressive rendering).
    seed:  uint32 per-(pixel, dimension-pair) hash.
    Returns (..., 2) float32 in [0,1).
    """
    index = _u32(index)
    seed = _u32(seed)
    # shuffle the sample index (decorrelates pixels without losing
    # stratification), then scramble each output dimension independently
    shuffled = owen_scramble(index, hash_combine(seed, U32(0x4D595DF4)))
    x = owen_scramble(_sobol_dim0(shuffled), hash_combine(seed, U32(0x968B6B5A)))
    y = owen_scramble(_sobol_dim1(shuffled), hash_combine(seed, U32(0x6E62F19B)))
    return jnp.stack([_to_unit_float(x), _to_unit_float(y)], axis=-1)


def pixel_seed(pixel_id, dim_pair):
    """Per-(pixel, dimension-pair) scramble seed."""
    return hash_combine(_u32(pixel_id), _u32(dim_pair) * U32(0x9E3779B9))


def rand2(pixel_id, frame, dim_pair):
    """The framework's main RNG entry: (...,2) low-discrepancy floats for a
    given pixel, frame (= progressive sample index) and even dimension pair —
    the analog of the reference's rand2(sampleDim) calls
    (reference: src/pathtrace.cuh:53-62 uses 16 dims/frame)."""
    return sobol_owen_2d(frame, pixel_seed(pixel_id, dim_pair))


def rand1(pixel_id, frame, dim):
    return rand2(pixel_id, frame, dim)[..., 0]


def white2(pixel_id, frame, dim_pair):
    """Pure hash white noise (the Wang-hash fallback path)."""
    h = hash_combine(hash_combine(pixel_id, frame), dim_pair)
    return jnp.stack([_to_unit_float(hash_pcg(h ^ U32(0x1)) ),
                      _to_unit_float(hash_pcg(h ^ U32(0x2)))], axis=-1)


# ---------------------------------------------------------------------------
# inter-pixel blue-noise sample distribution
# (reference: src/blueNoiseRandGen.h:75-156 — Heitz-Belcour scrambling/
#  ranking tiles.  Our mechanism: ONE shared Owen-Sobol sequence for all
#  pixels + a per-pixel Cranley-Patterson rotation drawn from a 64x64
#  void-and-cluster mask (Georgiev-Fajardo blue-noise dithered sampling).
#  For smooth integrands the 1-spp error then inherits the mask's blue
#  spectrum between pixels — the property the 1-spp denoiser feeds on.)
# ---------------------------------------------------------------------------

_BN_CACHE = None


def blue_noise_mask():
    """(64, 64, 2) float32 toroidal rank masks (tools/bluenoise_gen.py)."""
    global _BN_CACHE
    if _BN_CACHE is None:
        import os

        import numpy as np
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))), "resources",
            "bluenoise64.npy")
        _BN_CACHE = np.load(path)
    return _BN_CACHE


def blue_offsets_flat(w: int, h: int, n_pad: int):
    """Per-pixel CP offsets for a row-major (h, w) image, padded to n_pad
    rays: (n_pad, 2) f32 NUMPY array (a trace-time constant — returning
    numpy keeps callers free to re-permute it host-side before upload).
    Pure tiling — no gathers anywhere."""
    import numpy as np
    m = blue_noise_mask()
    reps_y = -(-h // m.shape[0])
    reps_x = -(-w // m.shape[1])
    full = np.tile(m, (reps_y, reps_x, 1))[:h, :w]
    flat = full.reshape(h * w, 2)
    if n_pad > h * w:
        flat = np.concatenate(
            [flat, np.broadcast_to(flat[-1], (n_pad - h * w, 2))])
    return np.ascontiguousarray(flat)


def _dim_shift(dim_pair):
    """Per-dimension toroidal decorrelation of the shared mask (a hashed
    [0,1)^2 shift per dim pair — pointwise, table-free)."""
    d = _u32(dim_pair)
    return (_to_unit_float(hash_pcg(d ^ U32(0xA511E9B3))),
            _to_unit_float(hash_pcg(d ^ U32(0x63D83595))))


def rand2_bn(bn2, frame, dim_pair):
    """Blue-noise-dithered LD pair: shared sequence, per-pixel CP rotation.

    bn2: (..., 2) mask offsets from `blue_offsets_flat`.  Matches
    kshade.rand2_bn_c component-for-component (the megakernel twin)."""
    base = sobol_owen_2d(frame, pixel_seed(U32(0), dim_pair))
    sx, sy = _dim_shift(dim_pair)
    ox = bn2[..., 0] + sx
    oy = bn2[..., 1] + sy
    u = base[..., 0] + (ox - jnp.floor(ox))
    v = base[..., 1] + (oy - jnp.floor(oy))
    return jnp.stack([u - jnp.floor(u), v - jnp.floor(v)], axis=-1)


# ---------------------------------------------------------------------------
# geometric warps (reference: src/bsdf.cuh:69-103, :300-331; raygen.cuh:17-38)
# ---------------------------------------------------------------------------


def concentric_disk(u):
    """Map [0,1)^2 to the unit disk with low distortion (Shirley-Chiu)."""
    ox = 2.0 * u[..., 0] - 1.0
    oy = 2.0 * u[..., 1] - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = jnp.abs(ox) > jnp.abs(oy)
    r = jnp.where(use_x, ox, oy)
    theta = jnp.where(use_x,
                      (jnp.pi / 4.0) * (oy / jnp.where(ox == 0, 1.0, ox)),
                      (jnp.pi / 2.0) - (jnp.pi / 4.0) * (ox / jnp.where(oy == 0, 1.0, oy)))
    pt = jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)
    return jnp.where(zero[..., None], 0.0, pt)


def cosine_hemisphere(u):
    """Cosine-weighted hemisphere sample about +z.  pdf = cos_theta / pi."""
    d = concentric_disk(u)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - d[..., 0] ** 2 - d[..., 1] ** 2))
    return vec3(d[..., 0], d[..., 1], z)


def uniform_hemisphere(u):
    """Uniform hemisphere about +z.  pdf = 1 / (2 pi)."""
    z = u[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = TWO_PI * u[..., 1]
    return vec3(r * jnp.cos(phi), r * jnp.sin(phi), z)


def uniform_sphere(u):
    """Uniform sphere.  pdf = 1 / (4 pi)."""
    z = 1.0 - 2.0 * u[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = TWO_PI * u[..., 1]
    return vec3(r * jnp.cos(phi), r * jnp.sin(phi), z)


def uniform_cone(u, cos_theta_max):
    """Uniform direction in a cone about +z.  pdf = 1/(2 pi (1-cos_max))."""
    cos_t = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    phi = TWO_PI * u[..., 1]
    return vec3(jnp.cos(phi) * sin_t, jnp.sin(phi) * sin_t, cos_t)


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (TWO_PI * jnp.maximum(1.0 - cos_theta_max, 1e-8))


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """MIS power heuristic (beta=2) (reference: src/bsdf.cuh:333)."""
    f = nf * f_pdf
    g = ng * g_pdf
    return jnp.where(f + g > 0.0, (f * f) / jnp.maximum(f * f + g * g, 1e-20), 0.0)
