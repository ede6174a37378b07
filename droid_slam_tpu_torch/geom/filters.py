"""Multiview depth filtering and back-projection for the reconstruction.

Counterpart of ``droid_slam_tpu/geom/filters.py`` (``depth_filter``,
``iproj_points``), which follows the reference's ``depth_filter_kernel``
and ``iproj_kernel``. Plain tensor functions on the caller's device,
vectorised over the queried frames and their six neighbours.
"""

from __future__ import annotations

import torch

from ..lie import se3
from .projective import coords_grid

# the frames each queried frame is tested against, as offsets from it: the
# reference kernel's neighbour map (three before, then ix+3..ix+5)
NEIGHBOURS = (-1, -2, -3, 3, 4, 5)


def _unit_rays(h, w, intrinsics, dtype, device):
    """[(u-cx)/fx, (v-cy)/fy] at every pixel: [h,w] each."""
    fx, fy, cx, cy = intrinsics.to(dtype).unbind(-1)
    grid = coords_grid(h, w, dtype=dtype, device=device)
    return (grid[..., 0] - cx) / fx, (grid[..., 1] - cy) / fy


def _safe_inv(d):
    return 1.0 / torch.where(d == 0, torch.full_like(d, 1e-8), d)


def depth_filter(poses, disps, intrinsics, inds, thresh):
    """Count, for each queried frame and pixel, how many of its neighbours
    (``NEIGHBOURS``; those outside [0, N) count 0) confirm its depth: the
    pixel warped into the neighbour lands inside it (u0 < w-1, v0 < h-1)
    and its depth is within ``thresh`` of the neighbour's at one of the 4
    surrounding pixels.

    poses [N,7], disps [N,h,w], intrinsics [4], inds [M], thresh [M].
    Returns counts [M,h,w] in the disparities' dtype."""
    N, h, w = disps.shape
    dev, dt = disps.device, disps.dtype
    inds = torch.as_tensor(inds, device=dev).long()
    thresh = torch.as_tensor(thresh, dtype=dt, device=dev)
    M = inds.shape[0]
    jx = inds[:, None] + torch.tensor(NEIGHBOURS, device=dev)   # [M,6]
    valid_j = (jx >= 0) & (jx < N)
    jxc = jx.clamp(0, N - 1)

    Gij = se3.relative(poses[inds][:, None], poses[jxc])       # [M,6,7]
    rx, ry = _unit_rays(h, w, intrinsics, dt, dev)
    di = disps[inds]
    X = torch.stack([rx.expand_as(di), ry.expand_as(di),
                     torch.ones_like(di), di], dim=-1)          # [M,h,w,4]
    Xj = se3.act(Gij[:, :, None, None, :], X[:, None])          # [M,6,h,w,4]
    z = Xj[..., 2]
    zsafe = torch.where(z == 0, torch.ones_like(z), z)
    fx, fy, cx, cy = intrinsics.to(dt).unbind(-1)
    u0 = torch.floor(fx * (Xj[..., 0] / zsafe) + cx)
    v0 = torch.floor(fy * (Xj[..., 1] / zsafe) + cy)
    zj = _safe_inv(Xj[..., 3] / zsafe)
    # the test on the floored coordinates in floating point: a NaN fails it
    inb = (u0 >= 0) & (v0 >= 0) & (u0 < w - 1) & (v0 < h - 1) \
        & valid_j[:, :, None, None]
    u0c = torch.nan_to_num(u0).clamp(0, w - 2).long()
    v0c = torch.nan_to_num(v0).clamp(0, h - 2).long()

    dmap = disps[jxc].reshape(M, 6, h * w)
    t = thresh[:, None, None, None]
    ok = torch.zeros_like(inb)
    for dv in (0, 1):
        for du in (0, 1):
            idx = ((v0c + dv) * w + (u0c + du)).reshape(M, 6, h * w)
            zn = _safe_inv(dmap.gather(2, idx)).reshape(M, 6, h, w)
            ok |= (zj - zn).abs() < t
    return (ok & inb).to(dt).sum(dim=1)


def iproj_points(poses, disps, intrinsics):
    """Every pixel of every frame back-projected to world coordinates:
    poses [N,7] (world-to-camera), disps [N,h,w] -> [N,h,w,3]."""
    N, h, w = disps.shape
    rx, ry = _unit_rays(h, w, intrinsics, disps.dtype, disps.device)
    d = torch.where(disps == 0, torch.full_like(disps, 1e-8), disps)
    Xc = torch.stack([rx.expand_as(disps), ry.expand_as(disps),
                      torch.ones_like(disps)], dim=-1) / d[..., None]
    return se3.act3(se3.inv(poses)[:, None, None, :], Xc)
