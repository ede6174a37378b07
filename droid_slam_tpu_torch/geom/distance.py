"""Flow-magnitude frame distance, the keyframe and edge-proposal metric.

Counterpart of ``droid_slam_tpu/geom/distance.py``: the mean reprojection
flow, blended between the full SE3 warp (weight beta) and a translation-only
warp (1-beta); 1000.0 when fewer than 75% of pixels land in front of the
camera.
"""

from __future__ import annotations

import torch

from ..lie import se3
from .projective import MIN_DEPTH_BA, coords_grid, iproj


def _directed_distance(poses, disps, intrinsics, ii, jj, beta):
    ht, wd = disps.shape[-2:]
    fx, fy, cx, cy = intrinsics.unbind(-1)
    grid = coords_grid(ht, wd, disps.dtype, disps.device)
    X0 = iproj(disps[ii], intrinsics.expand(ii.shape[0], 4))
    Gij = se3.relative(poses[ii], poses[jj])

    def flow_mag(X1):
        z = X1[..., 2]
        zsafe = torch.where(z <= 0, torch.ones_like(z), z)
        du = fx * (X1[..., 0] / zsafe) + cx - grid[..., 0]
        dv = fy * (X1[..., 1] / zsafe) + cy - grid[..., 1]
        valid = (z > MIN_DEPTH_BA).to(disps.dtype)
        return torch.sqrt(du * du + dv * dv), valid

    mag_f, val_f = flow_mag(se3.act(Gij[:, None, None, :], X0))
    X1_tr = torch.cat([X0[..., :3] + X0[..., 3:4] * Gij[:, None, None, :3],
                       X0[..., 3:4]], dim=-1)
    mag_t, val_t = flow_mag(X1_tr)

    accum = beta * (mag_f * val_f).sum((-2, -1)) + \
        (1.0 - beta) * (mag_t * val_t).sum((-2, -1))
    valid = beta * val_f.sum((-2, -1)) + (1.0 - beta) * val_t.sum((-2, -1))
    frac = valid / (float(ht * wd) + 1e-8)
    d = accum / torch.where(valid > 0, valid, torch.ones_like(valid))
    return torch.where(frac < 0.75, torch.full_like(d, 1000.0), d)


def frame_distance(poses, disps, intrinsics, ii, jj, beta=0.3,
                   bidirectional=True):
    """Distance of each pair (ii[k], jj[k]); intrinsics is one [4] vector."""
    d1 = _directed_distance(poses, disps, intrinsics, ii, jj, beta)
    if not bidirectional:
        return d1
    return 0.5 * (d1 + _directed_distance(poses, disps, intrinsics, jj, ii,
                                          beta))
