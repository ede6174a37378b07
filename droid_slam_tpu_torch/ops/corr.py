"""Correlation volumes, their pyramid, and the plain window lookup.

Counterpart of ``droid_slam_tpu/ops/corr.py:34-112``. A volume is
``[E, HW, h2, w2]``: for each source pixel, its correlation with every
target pixel, pooled 2x per level. ``lookup_level_plain`` is the plain
PyTorch twin of the CUDA kernel in ``csrc/corr_lookup.cu`` (wrapper:
``ops/corr_cuda.py``): for each (edge, pixel) a bilinear (2r+1)^2 window
around the warped coordinate, zero outside the volume, channels ordered
x-offset-major.
"""

from __future__ import annotations

import torch

NUM_LEVELS = 4
RADIUS = 3


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 mean over the last two dims (odd row/col dropped)."""
    h, w = x.shape[-2] // 2, x.shape[-1] // 2
    x = x[..., :2 * h, :2 * w]
    s = ((x[..., 0::2, 0::2] + x[..., 0::2, 1::2])
         + (x[..., 1::2, 0::2] + x[..., 1::2, 1::2]))
    return s * 0.25


def build_volume(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """fmaps [E,C,h,w] -> [E, h*w, h, w] = (f1/4).(f2/4) over channels, in
    f32, stored bf16 when the features are bf16."""
    E, C, h, w = fmap1.shape
    f1 = fmap1.reshape(E, C, h * w).float() / 4.0
    f2 = fmap2.reshape(E, C, h * w).float() / 4.0
    corr = torch.bmm(f1.transpose(1, 2), f2)
    bf16 = fmap1.dtype == torch.bfloat16
    return corr.reshape(E, h * w, h, w).to(
        torch.bfloat16 if bf16 else torch.float32)


def build_pyramid(fmap1, fmap2, num_levels: int = NUM_LEVELS):
    """[[E,HW,h/2^l,w/2^l] for l in levels]."""
    vol = build_volume(fmap1, fmap2)
    pyramid = [vol]
    for _ in range(num_levels - 1):
        vol = avg_pool2(vol)
        pyramid.append(vol)
    return pyramid


def lookup_level_plain(vol: torch.Tensor, slots: torch.Tensor,
                       coords: torch.Tensor, radius: int = RADIUS):
    """Window lookup on one level through a slot table.

    vol [EB,HW,h2,w2]; slots [EA] (edge a reads volume slots[a]);
    coords [EA,HW,2] (x, y) at this level's scale.
    Returns [EA,HW,(2r+1)^2] f32, x-offset-major.
    """
    EB, HW, h2, w2 = vol.shape
    EA = slots.shape[0]
    r = radius
    rd = 2 * r + 1
    x0 = torch.floor(coords[..., 0])
    y0 = torch.floor(coords[..., 1])
    dx = (coords[..., 0] - x0)[..., None]
    dy = (coords[..., 1] - y0)[..., None]

    # (rd+1)^2 integer grid: tap (i, j) at (x0 - r + i, y0 - r + j)
    ti = torch.arange(rd + 1, dtype=coords.dtype, device=coords.device)
    xi = (x0[..., None, None] - r + ti[:, None]).expand(EA, HW, rd + 1, rd + 1)
    yj = (y0[..., None, None] - r + ti[None, :]).expand(EA, HW, rd + 1, rd + 1)
    inb = (xi >= 0) & (xi < w2) & (yj >= 0) & (yj < h2)
    idx = torch.where(inb, yj * w2 + xi, 0).long()
    row = slots.long()[:, None] * HW + torch.arange(HW, device=vol.device)
    flat = row[..., None, None] * (h2 * w2) + idx
    taps = vol.reshape(-1).take(flat).float() * inb.float()

    out = ((1 - dx) * (1 - dy))[..., None] * taps[:, :, :rd, :rd] \
        + (dx * (1 - dy))[..., None] * taps[:, :, 1:, :rd] \
        + ((1 - dx) * dy)[..., None] * taps[:, :, :rd, 1:] \
        + (dx * dy)[..., None] * taps[:, :, 1:, 1:]
    return out.reshape(EA, HW, rd * rd)


def lookup_pyramid_plain(pyramid, slots, coords, radius: int = RADIUS):
    """All levels at level-0 coords [EA,HW,2] -> [EA,HW,L*(2r+1)^2],
    level-major channels."""
    return torch.cat([lookup_level_plain(vol, slots, coords / (2.0 ** lvl),
                                         radius)
                      for lvl, vol in enumerate(pyramid)], dim=-1)
