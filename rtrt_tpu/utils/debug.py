"""Debug utilities: NaN detection, bounds-checked gathers, array dumps.

Counterpart of the reference's debug layer
(reference: src/debugUtil.h — NAN_DETECTER :143-159, SAFE_LOAD bounds
checks :162-183, CSV device-array dumps :106-129, center-pixel print :11-17,
PPM frame dump :78-103).

Debug checks are jit-compatible: `nan_guard` zeroes NaNs and counts them
(reported via jax.debug.print under the flag), `safe_gather` clamps indices
and flags violations.  Enabled globally by RTRT_DEBUG=1 or per-call.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

DEBUG = os.environ.get("RTRT_DEBUG", "0") == "1"


def nan_guard(x, label: str = "", enabled: bool | None = None):
    """Replace NaN/Inf with zeros; report count when debugging
    (NAN_DETECTER analog — the reference also zeroes and reports)."""
    if enabled is None:
        enabled = DEBUG
    if not enabled:
        return x
    bad = ~jnp.isfinite(x)
    n_bad = jnp.sum(bad)
    jax.debug.print("[nan_guard:" + label + "] bad values: {}", n_bad)
    return jnp.where(bad, 0.0, x)


def safe_gather(table, idx, label: str = "", enabled: bool | None = None):
    """Bounds-checked gather: clamps out-of-range indices; reports when
    debugging (SAFE_LOAD analog)."""
    if enabled is None:
        enabled = DEBUG
    n = table.shape[0]
    clamped = jnp.clip(idx, 0, n - 1)
    if enabled:
        oob = jnp.sum((idx < 0) | (idx >= n))
        jax.debug.print("[safe_gather:" + label + "] oob indices: {}", oob)
    return table[clamped]


def center_pixel_print(img, label: str = ""):
    """Print the center pixel of an (H,W,C) image (DEBUG_PRINT analog)."""
    h, w = img.shape[0], img.shape[1]
    jax.debug.print("[center:" + label + "] {}", img[h // 2, w // 2])


def dump_csv(path: str, array, fmt: str = "%.7g"):
    """Dump a device array as CSV for offline diffing — the verification
    hook the reference exposes for every BVH intermediate
    (reference: src/bvh.cu:15-96)."""
    a = np.asarray(array)
    a2 = a.reshape(a.shape[0], -1) if a.ndim > 1 else a.reshape(-1, 1)
    np.savetxt(path, a2, delimiter=",", fmt=fmt)


def dump_bvh_intermediates(dirpath: str, bvh):
    """CSV-dump the BVH build products (morton/reorder/nodes), mirroring the
    reference's DEBUG_FRAME dumps."""
    os.makedirs(dirpath, exist_ok=True)
    dump_csv(os.path.join(dirpath, "sorted_tri_index.csv"),
             bvh.sorted_tri_index, fmt="%d")
    dump_csv(os.path.join(dirpath, "boxes_t.csv"), bvh.boxes_t.T)
    dump_csv(os.path.join(dirpath, "children_t.csv"), bvh.children_t.T,
             fmt="%d")
    dump_csv(os.path.join(dirpath, "root_aabb.csv"),
             jnp.stack([bvh.root_lo, bvh.root_hi]))


def frame_dump(path: str, img):
    """PPM/PNG frame dump (writeToPPM analog)."""
    from .image import write_png, write_ppm
    if path.endswith(".ppm"):
        write_ppm(path, img)
    else:
        write_png(path, img)
