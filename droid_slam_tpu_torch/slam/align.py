"""Trajectory fragment alignment: a least-squares scale and an SE3 mean.

Counterpart of ``droid_slam_tpu/slam/align.py``: the relative scale from the
pairwise translations of the two fragments, then a 3-iteration SE3 mean of
the residual transforms.
"""

from __future__ import annotations

import torch

from ..lie import se3


def align_pose_fragments(pose0, pose1):
    """pose0, pose1 [n,7] -> (dG [1,7], s [] tensor) such that
    pose1 ≈ dG ∘ (s * pose0)."""
    dP1 = se3.mul(se3.inv(pose0[None, :]), pose0[:, None])
    dP2 = se3.mul(se3.inv(pose1[None, :]), pose1[:, None])

    dt1 = dP1[..., :3].reshape(-1, 3)
    dt2 = dP2[..., :3].reshape(-1, 3)
    s = (dt1 * dt2).sum() / (dt1 * dt1).sum().clamp(min=1e-12)

    P0s = torch.cat([pose0[..., :3] * s, pose0[..., 3:]], dim=-1)
    dG = se3.mul(pose1, se3.inv(P0s))[:1]
    for _ in range(3):
        e = se3.log(se3.mul(pose1, se3.inv(se3.mul(dG, P0s))))
        dG = se3.mul(se3.exp(e.mean(dim=0, keepdim=True)), dG)
    return dG, s
