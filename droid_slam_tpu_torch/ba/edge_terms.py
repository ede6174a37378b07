"""Per-edge Gauss-Newton terms of dense bundle adjustment (f32).

Counterpart of ``droid_slam_tpu/ba/edge_terms.py`` in its factored form:
the i-side pose Jacobian is Ji = -Jj Ad(Gij), so every i-side block is a
per-edge 6x6 congruence of the j-side contraction. Layout: pixels last.
  r [E,2,HW] residuals target - proj
  w_pose, w_depth [E,2,HW] 0.001-scaled weights of the pose and the depth
    blocks: equal, except on stereo edges (ii == jj), whose pose weights are
    zero (the fixed baseline moves no pose) while their depth weights stay
  Jj [E,2,6,HW];  Jz [E,2,HW];  Adj [E,6,6]
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import projective as pops
from ..lie import se3


class EdgeTerms(NamedTuple):
    r: torch.Tensor
    w_pose: torch.Tensor
    w_depth: torch.Tensor
    Jj: torch.Tensor
    Jz: torch.Tensor
    Adj: torch.Tensor


def linearize(poses, disps, intrinsics, target, weight, ii, jj,
              min_depth=pops.MIN_DEPTH_BA, edge_valid=None,
              zero_stereo_pose=True) -> EdgeTerms:
    """Linearize the reprojection residuals of every edge; target/weight
    [E,2,HW]. Weights are scaled by 0.001 and zeroed where either point is
    behind ``min_depth`` and on the edges that ``edge_valid`` [E] (bool)
    marks as padding; stereo edges get zero pose weights unless
    ``zero_stereo_pose`` is False, as in the training BA
    (droid_slam_tpu/ba/edge_terms.py:87-96)."""
    E = ii.shape[0]
    hw = disps.shape[-2] * disps.shape[-1]
    coords, valid, (_, Jj, Jz) = pops.projective_transform(
        poses, disps, intrinsics, ii, jj, jacobian=True, min_depth=min_depth,
        factored_jac=True)
    Adj = se3.adj_matrix(pops.relative_poses(poses, ii, jj))
    r = target - coords.reshape(E, hw, 2).transpose(1, 2)
    w = 0.001 * weight * valid.reshape(E, 1, hw)
    if edge_valid is not None:
        w = w * edge_valid.to(w.dtype)[:, None, None]
    w_pose = (w * (1.0 - (ii == jj).to(w.dtype))[:, None, None]
              if zero_stereo_pose else w)
    Jj = Jj.reshape(E, hw, 2, 6).permute(0, 2, 3, 1)
    Jz = Jz.reshape(E, hw, 2).transpose(1, 2)
    return EdgeTerms(r=r, w_pose=w_pose, w_depth=w, Jj=Jj, Jz=Jz, Adj=Adj)


def pose_blocks(t: EdgeTerms):
    """Hii, Hij, Hji, Hjj [E,6,6] and vi, vj [E,6]."""
    Jw = t.Jj * t.w_pose[:, :, None]
    Hjj = torch.einsum("ecdh,ecfh->edf", Jw, t.Jj)
    vj = torch.einsum("ecdh,ech->ed", Jw, t.r)
    A = t.Adj
    HjjA = Hjj @ A
    Hii = A.transpose(1, 2) @ HjjA
    Hij = -(A.transpose(1, 2) @ Hjj)
    Hji = -HjjA
    vi = -(A.transpose(1, 2) @ vj[..., None])[..., 0]
    return Hii, Hij, Hji, Hjj, vi, vj


def depth_blocks(t: EdgeTerms):
    """Ei, Ej [E,6,HW] pose-depth coupling (pose weights), Cz [E,HW] depth
    diagonal, bz [E,HW] depth right-hand side (depth weights)."""
    # per pixel a [1,2] x [2,6] product, summed over the two rows by hand:
    # as an einsum it lowers to a cuBLAS batched GEMV of E*HW tiny products,
    # ~0.75 ms a call at the frontend's ~250 edges of 40x64 on the H100
    wJz = t.w_pose * t.Jz
    Ej = wJz[:, 0, None] * t.Jj[:, 0] + wJz[:, 1, None] * t.Jj[:, 1]
    Ei = -torch.einsum("eda,edh->eah", t.Adj, Ej)
    Cz = (t.w_depth * t.Jz * t.Jz).sum(1)
    bz = (t.w_depth * t.r * t.Jz).sum(1)
    return Ei, Ej, Cz, bz
