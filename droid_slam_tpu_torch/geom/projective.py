"""Pinhole projective geometry with analytic Jacobians.

Counterpart of ``droid_slam_tpu/geom/projective.py``, with the same layouts:
poses [N,7], disps [N,H,W] (inverse depth at 1/8 resolution), intrinsics
[N,4] = [fx,fy,cx,cy] at that resolution, edge lists ii/jj [E]; outputs are
edge-major [E,H,W,...]. Homogeneous points are X = [x, y, 1, d]. A stereo
edge (ii == jj) joins a keyframe's left view to its right view: its relative
pose is the fixed rectified baseline Gij = [-0.1,0,0, 0,0,0,1].
"""

from __future__ import annotations

import functools

import torch

from ..lie import se3

MIN_DEPTH = 0.2
MIN_DEPTH_BA = 0.25


@functools.lru_cache(maxsize=None)
def _stereo_gij(dtype, device):
    """The stereo edges' Gij, made once per device (no copy per call)."""
    return torch.tensor([-0.1, 0, 0, 0, 0, 0, 1], dtype=dtype, device=device)


def coords_grid(ht: int, wd: int, dtype=torch.float32, device=None):
    """Pixel grid [ht, wd, 2] with (x, y) ordering."""
    y, x = torch.meshgrid(torch.arange(ht, dtype=dtype, device=device),
                          torch.arange(wd, dtype=dtype, device=device),
                          indexing="ij")
    return torch.stack([x, y], dim=-1)


def _intr(intrinsics):
    return intrinsics[..., None, None, :].unbind(-1)


def iproj(disps, intrinsics):
    """Disparity maps -> homogeneous points [..., H, W, 4]."""
    ht, wd = disps.shape[-2:]
    fx, fy, cx, cy = _intr(intrinsics)
    grid = coords_grid(ht, wd, disps.dtype, disps.device)
    x = (grid[..., 0] - cx) / fx
    y = (grid[..., 1] - cy) / fy
    return torch.stack([x, y, torch.ones_like(disps), disps], dim=-1)


def proj(X, intrinsics):
    """Projection of homogeneous points X[..., 4] -> coords [..., 2]."""
    fx, fy, cx, cy = _intr(intrinsics)
    x, y, z, _ = X.unbind(-1)
    z = torch.where(z < 0.5 * MIN_DEPTH, torch.ones_like(z), z)
    d = 1.0 / z
    return torch.stack([fx * (x * d) + cx, fy * (y * d) + cy], dim=-1)


def relative_poses(poses, ii, jj):
    """Gij = poses[jj] * poses[ii]^-1, and the rectified baseline on stereo
    edges (droid_slam_tpu/geom/projective.py:103-108). The frame distance
    (geom/distance.py) takes no such override."""
    Gij = se3.relative(poses[ii], poses[jj])
    return torch.where((ii == jj)[..., None],
                       _stereo_gij(Gij.dtype, Gij.device), Gij)


def projective_transform(poses, disps, intrinsics, ii, jj, jacobian=False,
                         min_depth=MIN_DEPTH, factored_jac=False):
    """Map pixels of frames ii into frames jj.

    Returns (coords [E,H,W,2], valid [E,H,W,1], (Ji, Jj, Jz) or None) with
    Ji/Jj [E,H,W,2,6] left-perturbation pose Jacobians and Jz [E,H,W,2,1]
    the inverse-depth Jacobian. With ``factored_jac`` Ji is None: the BA
    derives the i-side blocks from Jj and Ad(Gij) (Ji = -Jj Ad(Gij)).
    """
    X0 = iproj(disps[ii], intrinsics[ii])
    Gij = relative_poses(poses, ii, jj)
    X1 = se3.act(Gij[..., None, None, :], X0)
    coords = proj(X1, intrinsics[jj])
    valid = ((X1[..., 2] > min_depth) & (X0[..., 2] > min_depth))
    valid = valid[..., None].to(coords.dtype)
    if not jacobian:
        return coords, valid, None

    fx = intrinsics[jj][..., None, None, 0]
    fy = intrinsics[jj][..., None, None, 1]
    x, y, z, hc = X1.unbind(-1)
    d = 1.0 / torch.where(z < 0.5 * min_depth, torch.ones_like(z), z)
    d2 = d * d
    o = torch.zeros_like(d)
    Jj_u = torch.stack([fx * hc * d, o, -fx * x * hc * d2,
                        -fx * x * y * d2, fx * (1.0 + x * x * d2),
                        -fx * y * d], dim=-1)
    Jj_v = torch.stack([o, fy * hc * d, -fy * y * hc * d2,
                        -fy * (1.0 + y * y * d2), fy * x * y * d2,
                        fy * x * d], dim=-1)
    Jj = torch.stack([Jj_u, Jj_v], dim=-2)
    Ji = None if factored_jac else -se3.adjT(Gij[..., None, None, None, :], Jj)

    tij = Gij[..., None, None, :3]
    Jz_u = fx * (tij[..., 0] * d - tij[..., 2] * x * d2)
    Jz_v = fy * (tij[..., 1] * d - tij[..., 2] * y * d2)
    Jz = torch.stack([Jz_u, Jz_v], dim=-1)[..., None]
    return coords, valid, (Ji, Jj, Jz)


def projmap(poses, disps, intrinsics, ii, jj):
    """Reprojection coordinate maps and validity per edge
    (droid_slam_tpu/geom/projective.py:166-193): Gij = poses[jj] *
    poses[ii]^-1 with no stereo override, the identity pixel grid where the
    transformed z <= 0.01, the division by the true z, and valid where
    z > MIN_DEPTH_BA. Returns (coords [E,H,W,2], valid [E,H,W,1])."""
    ht, wd = disps.shape[-2:]
    X0 = iproj(disps[ii], intrinsics[ii])
    Gij = se3.relative(poses[ii], poses[jj])
    X1 = se3.act(Gij[..., None, None, :], X0)
    x, y, z = X1[..., 0], X1[..., 1], X1[..., 2]
    fx, fy, cx, cy = _intr(intrinsics[jj])
    front = z > 0.01
    d = 1.0 / torch.where(front, z, torch.ones_like(z))
    grid = coords_grid(ht, wd, disps.dtype, disps.device)
    u = torch.where(front, fx * (x * d) + cx, grid[..., 0])
    v = torch.where(front, fy * (y * d) + cy, grid[..., 1])
    coords = torch.stack([u, v], dim=-1)
    valid = (z > MIN_DEPTH_BA)[..., None].to(coords.dtype)
    return coords, valid


def induced_flow(poses, disps, intrinsics, ii, jj):
    """Optical flow that the camera motion induces over the edges, and its
    validity (droid_slam_tpu/geom/projective.py:196-200)."""
    ht, wd = disps.shape[-2:]
    coords0 = coords_grid(ht, wd, disps.dtype, disps.device)
    coords1, valid, _ = projective_transform(poses, disps, intrinsics, ii, jj)
    return coords1 - coords0, valid
