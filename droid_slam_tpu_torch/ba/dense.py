"""Differentiable dense bundle adjustment of the training forward.

Counterpart of ``droid_slam_tpu/ba/dense.py``: the per-pixel inverse depths
are eliminated with a dense Schur complement and the pose system is solved
with a damped Cholesky factorization; gradients flow through the
Jacobians, the solve and the retraction. It differs from the inference BA
(``ba/inference.py``) in three ways, as in the JAX package:
  * the pose diagonal is damped BEFORE the Schur subtraction
    (droid_slam_tpu/ba/dense.py:14-17,88-91);
  * the validity test uses depth 0.2, not 0.25, and stereo edges keep their
    pose weights;
  * the depth variables are all N frames, and the pose-depth coupling is
    dense, [P, N, 6, HW]: small at the training sizes (N=7: 2.6 MB).
Padded edges are masked by ``edge_valid``. Shapes per sample: target/weight
[E,2,HW], eta [N,HW], poses [N,7], disps [N,h,w], intrinsics [N,4].
"""

from __future__ import annotations

import torch

from ..lie import se3
from . import edge_terms
from .solver import solve_psd

MIN_DEPTH = 0.2


def _scatter(vals, idx, valid, n):
    """Sum rows of vals into n slots at idx; rows with valid False are
    dropped (they land in a spare slot)."""
    idx = torch.where(valid, idx, n)
    out = vals.new_zeros((n + 1,) + vals.shape[1:])
    return out.index_add_(0, idx, vals)[:-1]


def _pose_system(t, ii, jj, fixedp, P, ep, lm):
    """The damped pose Hessian [P*6, P*6] and its right-hand side [P*6]."""
    Hii, Hij, Hji, Hjj, vi, vj = edge_terms.pose_blocks(t)
    ei, ej = ii - fixedp, jj - fixedp
    rows = torch.cat([ei, ei, ej, ej])
    cols = torch.cat([ei, ej, ei, ej])
    ok = (rows >= 0) & (cols >= 0) & (rows < P) & (cols < P)
    H = _scatter(torch.cat([Hii, Hij, Hji, Hjj]), rows * P + cols, ok,
                 P * P).reshape(P, P, 6, 6)
    pv = torch.cat([ei, ej])
    v = _scatter(torch.cat([vi, vj]), pv, (pv >= 0) & (pv < P), P)
    Hd = H.permute(0, 2, 1, 3).reshape(P * 6, P * 6)
    eye = torch.eye(P * 6, dtype=Hd.dtype, device=Hd.device)
    return Hd + (ep + lm * Hd) * eye, v.reshape(-1)


def _linearize(target, weight, poses, disps, intrinsics, ii, jj,
               edge_valid):
    return edge_terms.linearize(poses, disps, intrinsics, target, weight, ii,
                                jj, min_depth=MIN_DEPTH,
                                edge_valid=edge_valid, zero_stereo_pose=False)


def _retract(poses, dx, fixedp):
    return torch.cat([poses[:fixedp], se3.retr(poses[fixedp:], dx)])


def ba_step(target, weight, eta, poses, disps, intrinsics, ii, jj,
            edge_valid=None, fixedp: int = 1, ep: float = 0.1,
            lm: float = 1e-4):
    """One Gauss-Newton step on one sample; returns (poses, disps)."""
    N, h, w = disps.shape
    hw = h * w
    P = N - fixedp
    t = _linearize(target, weight, poses, disps, intrinsics, ii, jj,
                   edge_valid)
    Hd, v = _pose_system(t, ii, jj, fixedp, P, ep, lm)
    Ei, Ej, Cz, bz = edge_terms.depth_blocks(t)

    # pose-depth coupling, dense over all N depth frames: [P, N, 6, HW]
    ei, ej = ii - fixedp, jj - fixedp
    pe = torch.cat([ei, ej])
    Emat = _scatter(torch.cat([Ei, Ej]), pe * N + torch.cat([ii, ii]),
                    (pe >= 0) & (pe < P), P * N).reshape(P, N, 6, hw)
    C = Cz.new_zeros((N, hw)).index_add_(0, ii, Cz) + eta + 1e-7
    wz = bz.new_zeros((N, hw)).index_add_(0, ii, bz).reshape(-1)

    Q = (1.0 / C).reshape(-1)
    Ed = Emat.permute(0, 2, 1, 3).reshape(P * 6, N * hw)
    EQ = Ed * Q
    S = Hd - EQ @ Ed.T
    dx = solve_psd(S, v - EQ @ wz)
    dz = Q * (wz - Ed.T @ dx)

    poses = _retract(poses, dx.reshape(P, 6), fixedp)
    disps = disps + dz.reshape(N, h, w)
    disps = torch.where(disps > 10.0, torch.zeros_like(disps), disps)
    return poses, disps.clamp(min=0.0)


def motion_step(target, weight, poses, disps, intrinsics, ii, jj,
                edge_valid=None, fixedp: int = 1, ep: float = 0.1,
                lm: float = 1e-4):
    """One motion-only step on one sample (depths fixed); returns poses."""
    P = disps.shape[0] - fixedp
    t = _linearize(target, weight, poses, disps, intrinsics, ii, jj,
                   edge_valid)
    Hd, v = _pose_system(t, ii, jj, fixedp, P, ep, lm)
    return _retract(poses, solve_psd(Hd, v).reshape(P, 6), fixedp)


def bundle_adjust(target, weight, eta, poses, disps, intrinsics, ii, jj,
                  edge_valid=None, fixedp: int = 1, ep: float = 0.1,
                  lm: float = 1e-4):
    """Batched full BA step: target/weight [B,E,2,HW], eta [B,N,HW], poses
    [B,N,7], disps [B,N,h,w], intrinsics [B,N,4]; ii/jj shared."""
    out = [ba_step(*args, ii, jj, edge_valid=edge_valid, fixedp=fixedp,
                   ep=ep, lm=lm)
           for args in zip(target, weight, eta, poses, disps, intrinsics)]
    return (torch.stack([p for p, _ in out]),
            torch.stack([d for _, d in out]))


def motion_only(target, weight, poses, disps, intrinsics, ii, jj,
                edge_valid=None, fixedp: int = 1, ep: float = 0.1,
                lm: float = 1e-4):
    """Batched motion-only BA step; returns poses [B,N,7]."""
    return torch.stack([
        motion_step(*args, ii, jj, edge_valid=edge_valid, fixedp=fixedp,
                    ep=ep, lm=lm)
        for args in zip(target, weight, poses, disps, intrinsics)])
