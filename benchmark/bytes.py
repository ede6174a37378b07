"""Bytes the correlation lookup kernel (``csrc/corr_lookup.cu``) must move,
the numerator of ``corr_lookup_roofline``: its output (196 f32 channels per
pixel), its coordinates (2 f32) and slot (one int32) per edge, and each
volume element that a pixel's 8x8 bilinear footprint touches inside the
map, read once. A frozen copy of the count in ``chip_smoke.py``'s kernels
phase; where the coordinates are not at hand (inside a CUDA graph) they are
taken at the identity warp, which moves a footprint by at most the flow of
a frame (a few pixels at the first level)."""

from __future__ import annotations

import numpy as np

LEVELS = 4
RADIUS = 3


def touched(coords, h2, w2):
    """Volume elements inside an h2 x w2 level that the footprints at
    ``coords`` [..., 2] (x, y at the level's scale) touch."""
    lo = np.floor(coords) - RADIUS
    nx = np.clip(np.minimum(lo[..., 0] + 8, w2) - np.maximum(lo[..., 0], 0),
                 0, 8)
    ny = np.clip(np.minimum(lo[..., 1] + 8, h2) - np.maximum(lo[..., 1], 0),
                 0, 8)
    return int((nx * ny).sum())


def lookup(E, h, w, elem=2, coords=None):
    """Bytes of one launch over E edges of an h x w map with volumes of
    ``elem``-byte elements; ``coords`` [E, h*w, 2] at level 0, or the
    pixel grid when None."""
    if coords is None:
        y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        grid = np.stack([x, y], -1).reshape(1, h * w, 2).astype(np.float64)
        coords, reps = grid, E
    else:
        coords, reps = np.asarray(coords, np.float64), 1
    n = 0
    for lvl in range(LEVELS):
        n += touched(coords / 2.0 ** lvl, h >> lvl, w >> lvl) * reps
    hw = h * w
    return E * hw * LEVELS * (2 * RADIUS + 1) ** 2 * 4 + E * hw * 2 * 4 \
        + E * 4 + n * elem
