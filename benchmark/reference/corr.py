"""The 4-level correlation pyramid of an edge and its radius-3 window
lookup, as DROID-SLAM's ``CorrBlock`` defines them: for each pixel of the
source frame, its dot product with every pixel of the target frame (each
feature divided by 4), pooled 2x per level; the lookup samples a 7x7
bilinear window around the warped coordinate on every level, zero outside
the map, channels level-major and x-offset-major within a level."""

from __future__ import annotations

import torch

LEVELS = 4
RADIUS = 3


def _pool(x):
    h, w = x.shape[-2] // 2, x.shape[-1] // 2
    x = x[..., :2 * h, :2 * w]
    return 0.25 * (x[..., 0::2, 0::2] + x[..., 0::2, 1::2]
                   + x[..., 1::2, 0::2] + x[..., 1::2, 1::2])


def pyramid(f1, f2):
    """fmaps [E,C,h,w] of the source and target frames -> the levels
    [E, h*w, h/2^l, w/2^l], in float32."""
    E, C, h, w = f1.shape
    a = f1.reshape(E, C, h * w).float() / 4.0
    b = f2.reshape(E, C, h * w).float() / 4.0
    vol = torch.bmm(a.transpose(1, 2), b).reshape(E, h * w, h, w)
    out = [vol]
    for _ in range(LEVELS - 1):
        out.append(_pool(out[-1]))
    return out


def _level(vol, coords, r=RADIUS):
    E, HW, h2, w2 = vol.shape
    d = 2 * r + 1
    x0, y0 = torch.floor(coords[..., 0]), torch.floor(coords[..., 1])
    fx = (coords[..., 0] - x0)[..., None, None]
    fy = (coords[..., 1] - y0)[..., None, None]
    off = torch.arange(-r, r + 2, device=vol.device, dtype=coords.dtype)
    xs = x0[..., None, None] + off[:, None]          # [E,HW,d+1(x),1]
    ys = y0[..., None, None] + off[None, :]          # [E,HW,1,d+1(y)]
    xs, ys = torch.broadcast_tensors(xs, ys)
    inb = (xs >= 0) & (xs < w2) & (ys >= 0) & (ys < h2)
    # the tap's index in integers: a float product rounds past h2*w2 in
    # lower precisions
    idx = torch.where(inb, ys.long() * w2 + xs.long(), 0)
    taps = torch.gather(vol.reshape(E, HW, h2 * w2), 2,
                        idx.reshape(E, HW, -1)).reshape(idx.shape)
    taps = taps.to(coords.dtype) * inb
    out = ((1 - fx) * (1 - fy) * taps[..., :d, :d]
           + fx * (1 - fy) * taps[..., 1:, :d]
           + (1 - fx) * fy * taps[..., :d, 1:]
           + fx * fy * taps[..., 1:, 1:])
    return out.reshape(E, HW, d * d)


def lookup(pyr, coords):
    """coords [E,h,w,2] (x, y) at level 0 -> [E, 196, h, w] in the
    coordinates' dtype."""
    E, h, w, _ = coords.shape
    c = coords.reshape(E, h * w, 2)
    out = torch.cat([_level(v, c / 2 ** l) for l, v in enumerate(pyr)], -1)
    return out.transpose(1, 2).reshape(E, -1, h, w)
