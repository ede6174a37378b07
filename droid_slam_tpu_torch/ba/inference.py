"""Inference-time dense bundle adjustment over a window of keyframes.

Counterpart of ``droid_slam_tpu/ba/inference.py`` for the monocular
frontend, on exact (unpadded) shapes. Per Gauss-Newton iteration:
linearize every edge, assemble the pose system, eliminate the per-pixel
inverse depths with the Schur complement, solve with f32 Cholesky, retract
the poses and back-substitute the depths. Carried over from the JAX package:
  * depth variables are the frames of ii and [t0, t1); free poses [t0, t1);
  * damping diag += ep + lm * diag after the Schur subtraction;
  * the back-substitution skips the first free pose (the reference's EvT
    ``idx <= 0`` quirk, ``droid_kernels.cu:1116``);
  * a step with a non-finite pose or depth update is dropped;
  * the motion-only path returns before that guard;
  * disparities are clamped to [0.001, _DISP_MAX] after the iterations.
The Schur complement is assembled densely: E_k [P*6, HW] couples each depth
frame k with every free pose, and S = sum_k E_k Q_k E_k^T.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..lie import se3
from . import edge_terms
from .solver import solve_psd

_DISP_MAX = 1e6


class BAPlan(NamedTuple):
    ii: torch.Tensor       # [E] long, source frames
    jj: torch.Tensor       # [E] long, target frames
    k_valid: torch.Tensor  # [NW] bool: window frame g0+k is a depth variable
    g0: int                # first frame of the depth window
    t0: int                # first free pose
    t1: int                # end of free poses (and of the window)


def build_plan(ii, jj, t0: int, t1: int, device) -> BAPlan:
    """Plan for the edge list (ii, jj) (host arrays) and free poses
    [t0, t1)."""
    ii = np.asarray(ii, np.int64)
    jj = np.asarray(jj, np.int64)
    g0 = int(min(ii.min(), jj.min(), t0)) if len(ii) else int(t0)
    end = int(max(t1, ii.max() + 1, jj.max() + 1)) if len(ii) else int(t1)
    k_valid = np.zeros(end - g0, bool)
    k_valid[t0 - g0:t1 - g0] = True
    k_valid[ii - g0] = True
    as_t = lambda a: torch.as_tensor(a, device=device)
    return BAPlan(ii=as_t(ii), jj=as_t(jj), k_valid=as_t(k_valid),
                  g0=g0, t0=int(t0), t1=int(t1))


def _scatter_pose_blocks(blocks, pi, pj, P):
    """Sum [E,6,6] blocks into the [P*6, P*6] pose system at (pi, pj);
    blocks with a fixed pose on either side drop out."""
    ok = (pi >= 0) & (pi < P) & (pj >= 0) & (pj < P)
    idx = torch.where(ok, pi * P + pj, P * P)
    out = blocks.new_zeros((P * P + 1, 6, 6)).index_add_(0, idx, blocks)
    return out[:-1].reshape(P, P, 6, 6).transpose(1, 2).reshape(P * 6, P * 6)


def _scatter_pose_vec(vecs, pi, P):
    idx = torch.where((pi >= 0) & (pi < P), pi, P)
    return vecs.new_zeros((P + 1, 6)).index_add_(0, idx, vecs)[:-1]


def _solve_pose_system(M, rhs, lm, ep):
    M = M + torch.diag(ep + lm * torch.diagonal(M))
    return solve_psd(M, rhs, refine_steps=1)


def ba_iterations(poses, disps, damping, intrinsics, target, weight,
                  plan: BAPlan, lm=1e-4, ep=0.1, iters: int = 2,
                  motion_only: bool = False):
    """``iters`` Gauss-Newton iterations; returns new (poses, disps).

    poses [B,7], disps/damping [B,h,w] are the keyframe buffers;
    target/weight [E,2,HW] align with plan.ii/jj; intrinsics is the shared
    [4] vector. The inputs are not modified.
    """
    B, h, w = disps.shape
    hw = h * w
    g0, t0, t1 = plan.g0, plan.t0, plan.t1
    NW = plan.k_valid.shape[0]
    P = t1 - t0
    ii, jj = plan.ii, plan.jj
    pi, pj = ii - t0, jj - t0
    ki = ii - g0
    intr_all = intrinsics.expand(B, 4)
    eta = 0.2 * damping[g0:g0 + NW].reshape(NW, hw) + 1e-7
    vi_ok = (pi >= 0) & (pi < P)
    vj_ok = (pj >= 0) & (pj < P)

    for _ in range(iters):
        t = edge_terms.linearize(poses, disps, intr_all, target, weight,
                                 ii, jj)
        Hii, Hij, Hji, Hjj, vi, vj = edge_terms.pose_blocks(t)
        A = _scatter_pose_blocks(torch.cat([Hii, Hij, Hji, Hjj]),
                                 torch.cat([pi, pi, pj, pj]),
                                 torch.cat([pi, pj, pi, pj]), P)
        v = _scatter_pose_vec(torch.cat([vi, vj]), torch.cat([pi, pj]), P)
        if motion_only:
            dx = _solve_pose_system(A, v.reshape(-1), lm, ep).reshape(P, 6)
            poses = poses.clone()
            poses[t0:t1] = se3.retr(poses[t0:t1], dx)
            continue

        Ei, Ej, Cz, bz = edge_terms.depth_blocks(t)
        C = Cz.new_zeros((NW, hw)).index_add_(0, ki, Cz) + eta
        wz = bz.new_zeros((NW, hw)).index_add_(0, ki, bz)
        Q = torch.where(plan.k_valid[:, None] & (C > 0), 1.0 / C,
                        torch.zeros_like(C))

        # E_k: coupling of depth frame k with each free pose (slot P drops
        # the rows of fixed poses)
        Ek = Ei.new_zeros((NW * (P + 1), 6, hw))
        Ek.index_add_(0, ki * (P + 1) + torch.where(vi_ok, pi, P), Ei)
        Ek.index_add_(0, ki * (P + 1) + torch.where(vj_ok, pj, P), Ej)
        Ek = Ek.reshape(NW, P + 1, 6, hw)[:, :P].reshape(NW, P * 6, hw)

        S = torch.bmm(Ek * Q[:, None], Ek.transpose(1, 2)).sum(0)
        S_rhs = torch.bmm(Ek, (Q * wz)[..., None]).sum(0)[:, 0]
        dx = _solve_pose_system(A - S, v.reshape(-1) - S_rhs, lm,
                                ep).reshape(P, 6)

        dx_bs = dx.clone()
        dx_bs[:1] = 0.0  # EvT quirk: pose t0 never reaches the depths
        acc = torch.einsum("krh,r->kh", Ek, dx_bs.reshape(-1))
        dz = Q * (wz - acc)

        new_poses = poses.clone()
        new_poses[t0:t1] = se3.retr(poses[t0:t1], dx)
        disps_w = disps[g0:g0 + NW].reshape(NW, hw)
        new_disps = disps.clone()
        new_disps[g0:g0 + NW] = torch.where(
            plan.k_valid[:, None], disps_w + dz, disps_w).reshape(NW, h, w)
        ok = torch.isfinite(dx).all() & torch.isfinite(dz).all()
        poses = torch.where(ok, new_poses, poses)
        disps = torch.where(ok, new_disps, disps)

    if not motion_only:
        disps = disps.clone()
        disps[g0:g0 + NW] = disps[g0:g0 + NW].clamp(0.001, _DISP_MAX)
    return poses, disps
