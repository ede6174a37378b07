"""Correlation volumes, their pyramid, the plain window lookup, and the
on-the-fly (alt) correlation of the global BA.

Counterpart of ``droid_slam_tpu/ops/corr.py:34-112,476-554``. A volume is
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

    vol [EB,HW,h2,w2]; slots [EA] (edge a reads volume slots[a]; a slot
    outside [0, EB) reads zeros); coords [EA,HW,2] (x, y) at this level's
    scale.
    Returns [EA,HW,(2r+1)^2] f32, x-offset-major.
    """
    EB, HW, h2, w2 = vol.shape
    EA = slots.shape[0]
    r = radius
    rd = 2 * r + 1
    if vol.numel() == 0:     # a level pooled to nothing reads zeros
        return coords.new_zeros((EA, coords.shape[1], rd * rd))
    x0 = torch.floor(coords[..., 0])
    y0 = torch.floor(coords[..., 1])
    dx = (coords[..., 0] - x0)[..., None]
    dy = (coords[..., 1] - y0)[..., None]

    # (rd+1)^2 integer grid: tap (i, j) at (x0 - r + i, y0 - r + j)
    ti = torch.arange(rd + 1, dtype=coords.dtype, device=coords.device)
    xi = (x0[..., None, None] - r + ti[:, None]).expand(EA, HW, rd + 1, rd + 1)
    yj = (y0[..., None, None] - r + ti[None, :]).expand(EA, HW, rd + 1, rd + 1)
    slot_ok = (slots >= 0) & (slots < EB)      # other slots read zeros
    inb = ((xi >= 0) & (xi < w2) & (yj >= 0) & (yj < h2)
           & slot_ok[:, None, None, None])
    idx = torch.where(inb, yj * w2 + xi, 0).long()
    row = (torch.where(slot_ok, slots, 0).long()[:, None] * HW
           + torch.arange(HW, device=vol.device))
    flat = row[..., None, None] * (h2 * w2) + idx
    # a gather, whose backward (the training forward's) is a scatter-add
    # with a deterministic form, where take's put_ has none on the card
    taps = vol.reshape(-1).gather(0, flat.reshape(-1)).reshape(flat.shape)
    taps = taps.float() * inb.float()

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


# ---------------------------------------------------------------------------
# alt correlation: the window computed from feature pyramids (global BA)
# ---------------------------------------------------------------------------

def build_fmap_pyramid(fmaps: torch.Tensor, num_levels: int = NUM_LEVELS):
    """fmaps [N,C,h,w] -> [[N,h/2^l,w/2^l,C] for l in levels], pooled 2x per
    level, channels last so that each sampled pixel is one contiguous row."""
    pyr = [fmaps]
    for _ in range(num_levels - 1):
        pyr.append(avg_pool2(pyr[-1]))
    return [p.permute(0, 2, 3, 1).contiguous() for p in pyr]


def _alt_level(f1, f2l, coords, jj, radius):
    """f1 [E,HW,C] f32 (level-0 source features), f2l [N,hl,wl,C], coords
    [E,HW,2] at this level's scale -> [E,HW,(2r+1)^2] f32, x-major.

    Dot products (/16, the volume's (f1/4).(f2/4)) on the (2r+2)^2 integer
    grid around each coordinate, zero outside the map, blended bilinearly
    to (2r+1)^2 taps. One grid row (2r+2 rows of the table gathered per
    pixel) at a time bounds the working set."""
    E, HW, C = f1.shape
    N, hl, wl, _ = f2l.shape
    r = radius
    D = 2 * r + 2
    rd = 2 * r + 1
    table = f2l.reshape(N * hl * wl, C)
    base = (jj * (hl * wl))[:, None, None]
    x0 = torch.floor(coords[..., 0])
    y0 = torch.floor(coords[..., 1])
    dx = (coords[..., 0] - x0)[..., None, None]
    dy = (coords[..., 1] - y0)[..., None, None]
    xi = x0[..., None] + (torch.arange(D, device=coords.device) - r)

    rows = []
    for di in range(D):                              # y offset
        yi = (y0 + (di - r))[..., None].expand_as(xi)
        inb = (xi >= 0) & (xi < wl) & (yi >= 0) & (yi < hl)
        idx = base + torch.where(inb, yi * wl + xi, 0).long()
        f2g = table[idx].float()                     # [E,HW,D,C]
        dot = torch.matmul(f2g, f1[..., None])[..., 0] / 16.0
        rows.append(dot * inb)
    ci = torch.stack(rows, dim=-2)                   # [E,HW,D(y),D(x)]
    out = ((1 - dx) * (1 - dy)) * ci[..., :rd, :rd] \
        + (dx * (1 - dy)) * ci[..., :rd, 1:] \
        + ((1 - dx) * dy) * ci[..., 1:, :rd] \
        + (dx * dy) * ci[..., 1:, 1:]
    return out.transpose(-1, -2).reshape(E, HW, rd * rd)


def alt_lookup(fmap_pyramid, coords, ii, jj, radius: int = RADIUS):
    """Correlation windows of the edges (ii -> jj) computed from the feature
    pyramid (build_fmap_pyramid) directly, without volumes. ii and jj are
    rows of the pyramid: frames, or with several views per frame the
    view-flattened rows n*c + view (a stereo edge's target row is its
    frame's right view).

    coords [E,HW,2] level-0 (x, y). Returns [E,HW,L*(2r+1)^2] f32,
    level-major channels, as lookup_pyramid_plain."""
    E, HW, _ = coords.shape
    f1 = fmap_pyramid[0][ii].reshape(E, HW, -1).float()
    return torch.cat([_alt_level(f1, f2l, coords / (2.0 ** lvl), jj, radius)
                      for lvl, f2l in enumerate(fmap_pyramid)], dim=-1)
