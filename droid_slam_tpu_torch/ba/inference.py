"""Inference-time dense bundle adjustment over a window of keyframes.

Counterpart of ``droid_slam_tpu/ba/inference.py``, on exact shapes (the
strict path, the global BA) or padded ones (the frame path's fixed shapes,
``build_plan_padded``): one body serves both. Per Gauss-Newton iteration:
linearize every edge, assemble the pose system, eliminate the per-pixel
inverse depths with the Schur complement, solve with f32 Cholesky, retract
the poses and back-substitute the depths. Carried over from the JAX package:
  * depth variables are the frames of ii and [t0, t1); free poses [t0, t1);
  * damping diag += ep + lm * diag after the Schur subtraction;
  * the back-substitution skips the first free pose (the reference's EvT
    ``idx <= 0`` quirk, ``droid_kernels.cu:1116``);
  * a step with a non-finite pose or depth update is dropped;
  * the motion-only path returns before that guard;
  * disparities are clamped to [0.001, _DISP_MAX] after the iterations;
  * the RGB-D prior where a sensor disparity d_s > 0 is set: C += ALPHA,
    w -= ALPHA (d - d_s), and the eta damping only where there is none
    (droid_slam_tpu/ba/inference.py:17-18,293-294,379-381).
The Schur complement is assembled from the JAX package's row table: one row
per window frame (its edges' i-side blocks summed, with that frame's pose)
and one row per edge (its j-side block, with pose jj), grouped by depth
frame; S = sum_k F_k Q_k F_k^T over each group F_k, 8 depth frames at a
time, scattered into the pose system by 6x6 block. Its cost is linear in
the edges: nothing couples a depth frame with every free pose.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..lie import se3
from . import edge_terms
from .solver import solve_psd

ALPHA = 0.05  # weight of the depth sensor's prior
_DISP_MAX = 1e6
_SCHUR_CHUNK = 8  # depth frames per block of the Schur assembly


class BAPlan(NamedTuple):
    ii: torch.Tensor         # [E] long, source frames
    jj: torch.Tensor         # [E] long, target frames
    k_valid: torch.Tensor    # [NW] bool: window frame g0+k is a depth variable
    row_pose: torch.Tensor   # [NW+E] long: free pose of each Schur row, or -1
    row_depth: torch.Tensor  # [NW+E] long: window depth frame of each row
    rk_idx: torch.Tensor     # [NW, RMAX] long: each depth frame's rows, -1 pad
    g0: int                  # first frame of the depth window
    t0: int                  # first free pose
    t1: int                  # end of free poses (and of the window)


def build_rows(ii, jj, t0: int, t1: int, g0: int, nw: int):
    """Schur row table of the edges (ii, jj) (host arrays) over the window
    [g0, g0+nw): rows [0, nw) are the window frames, row nw+e is edge e.
    Returns (row_pose, row_depth, rk_idx) as numpy; a row joins its depth
    frame's group only if its pose is free, in row order. Counterpart of
    ``droid_slam_tpu/ba/inference.py::_build_rows`` on exact shapes."""
    f = g0 + np.arange(nw)
    free = lambda x: np.where((x >= t0) & (x < t1), x - t0, -1)
    row_pose = np.concatenate([free(f), free(jj)])
    row_depth = np.concatenate([np.arange(nw), ii - g0])
    rows = np.flatnonzero(row_pose >= 0)
    rows = rows[np.argsort(row_depth[rows], kind="stable")]
    k = row_depth[rows]
    count = np.bincount(k, minlength=nw)
    slot = np.arange(len(rows)) - (np.cumsum(count) - count)[k]
    rk_idx = np.full((nw, max(int(count.max(initial=0)), 1)), -1, np.int64)
    rk_idx[k, slot] = rows
    return row_pose, row_depth, rk_idx


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
    row_pose, row_depth, rk_idx = build_rows(ii, jj, t0, t1, g0, end - g0)
    as_t = lambda a: torch.as_tensor(a, device=device)
    return BAPlan(ii=as_t(ii), jj=as_t(jj), k_valid=as_t(k_valid),
                  row_pose=as_t(row_pose), row_depth=as_t(row_depth),
                  rk_idx=as_t(rk_idx), g0=g0, t0=int(t0), t1=int(t1))


def _scatter_pose_vec(vecs, pi, P, n_free):
    """Sum [N,6] vectors into the [P,6] pose gradient at pi; entries whose
    pose is not free (pi outside [0, n_free), n_free <= P) drop out."""
    idx = torch.where((pi >= 0) & (pi < n_free), pi, P)
    return vecs.new_zeros((P + 1, 6)).index_add_(0, idx, vecs)[:-1]


def _scatter_pose_blocks(blocks, pi, pj, P, n_free):
    """Sum [E,6,6] blocks into the [P*6, P*6] pose system at (pi, pj);
    blocks with a fixed pose on either side drop out."""
    ok = (pi >= 0) & (pj >= 0) & (pi < n_free) & (pj < n_free)
    idx = torch.where(ok, pi * P + pj, P * P)
    out = blocks.new_zeros((P * P + 1, 6, 6)).index_add_(0, idx, blocks)
    return out[:-1].reshape(P, P, 6, 6).transpose(1, 2).reshape(P * 6,
                                                                 P * 6)


def _solve_masked(M, rhs, p_valid, lm, ep):
    """Damping after the Schur subtraction, then the rows and columns of
    the poses that are not free made identity (droid_slam_tpu/ba/
    inference.py:510-522)."""
    mask = p_valid.repeat_interleave(6)
    M = M + torch.diag(ep + lm * torch.diagonal(M))
    M = torch.where(mask[:, None] & mask[None, :], M, torch.zeros_like(M))
    M = M + torch.diag((~mask).to(M.dtype))
    return solve_psd(M, torch.where(mask, rhs, torch.zeros_like(rhs)),
                     refine_steps=1)


def window_put(buf, rows, vals):
    """``buf`` with rows ``rows`` [n] (ascending from rows[0] < len(buf))
    set to ``vals`` [n, ...], out of place; rows past the buffer's end are
    dropped (each writes row rows[0] with vals[0] again, so that no index
    leaves the buffer and the duplicates agree)."""
    inb = rows < buf.shape[0]
    idx = torch.where(inb, rows, rows[:1])
    m = inb.reshape((-1,) + (1,) * (vals.dim() - 1))
    return buf.index_copy(0, idx, torch.where(m, vals, vals[:1]))


def _schur(Ei, Ej, Q, qw, ki, plan: BAPlan, P):
    """S = E Q E^T [P*6, P*6] and S_rhs = E Q w [P*6] from the row table
    (its row_pose names each row's free pose, < P, or -1), and the rows
    Erows [NW+E,6,HW]: the window frames' summed i-side blocks,
    then each edge's j-side block. S is summed over groups of
    ``_SCHUR_CHUNK`` depth frames: per group, the [CK, 6*RMAX, 6*RMAX]
    product of its rows scattered into the pose system by 6x6 block."""
    NW, hw = Q.shape
    rp, rk = plan.row_pose, plan.rk_idx
    RMAX = rk.shape[1]
    Erows = torch.cat([Ei.new_zeros((NW, 6, hw)).index_add_(0, ki, Ei), Ej])
    S = Q.new_zeros((P * P + 1, 6, 6))
    for c0 in range(0, NW, _SCHUR_CHUNK):
        idx = rk[c0:c0 + _SCHUR_CHUNK]
        CK = idx.shape[0]
        ok = idx >= 0
        F = Erows[idx.clamp(min=0)] * ok[..., None, None]
        G = torch.bmm((F * Q[c0:c0 + CK, None, None]).reshape(CK, -1, hw),
                      F.reshape(CK, -1, hw).transpose(1, 2))
        G = G.reshape(CK, RMAX, 6, RMAX, 6).transpose(2, 3)
        p = torch.where(ok, rp[idx.clamp(min=0)], -1)
        p1, p2 = p[:, :, None], p[:, None, :]
        bins = torch.where((p1 >= 0) & (p2 >= 0), p1 * P + p2, P * P)
        S.index_add_(0, bins.reshape(-1), G.reshape(-1, 6, 6))
    S = S[:-1].reshape(P, P, 6, 6).transpose(1, 2).reshape(P * 6, P * 6)
    rhs = torch.bmm(Erows, qw[plan.row_depth][..., None])[..., 0]
    S_rhs = _scatter_pose_vec(rhs, rp, P, P).reshape(-1)
    return S, S_rhs, Erows


# ---------------------------------------------------------------------------
# padded plans: the frame path's fixed shapes (droid_slam_tpu/ba/
# inference.py:89-227,268-531)
# ---------------------------------------------------------------------------

WINDOW_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)
RMAX_BUCKETS = (8, 16, 32, 64, 128)


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"size {n} exceeds largest bucket {buckets[-1]}")


class PaddedShape(NamedTuple):
    """The padded sizes, part of the key of a captured frame program."""
    edges: int
    window: int
    rmax: int


def build_plan_padded(ii, jj, t0: int, t1: int, valid, edges: int,
                      window: int, rmax: int):
    """(PaddedShape, host arrays) of the plan for a padded edge layout:
    ``valid`` marks the real edges of ii/jj (length <= edges); the window
    and the row groups are padded to at least ``window`` and ``rmax``.
    The arrays, in packing order: ii, jj, edge_valid [E], k_valid [NW],
    row_pose, row_depth [NW+E], rk_idx [NW,RMAX], then g0, t0, t1.
    Rows join their depth frame's group in row order, as
    ``droid_slam_tpu/ba/inference.py::_build_rows`` orders them."""
    ii = np.asarray(ii, np.int64)
    jj = np.asarray(jj, np.int64)
    valid = np.asarray(valid, bool)
    vi, vj = ii[valid], jj[valid]
    g0 = int(min(vi.min(), vj.min(), t0)) if len(vi) else int(t0)
    nw = t1 - g0
    NW = window if window >= nw else _bucket(nw, WINDOW_BUCKETS)
    E = edges
    ii_p = np.full(E, g0, np.int64)
    jj_p = np.full(E, g0, np.int64)
    ii_p[:len(ii)] = np.where(valid, ii, g0)
    jj_p[:len(jj)] = np.where(valid, jj, g0)
    edge_valid = np.zeros(E, bool)
    edge_valid[:len(ii)] = valid

    k_valid = np.zeros(NW, bool)
    k_valid[max(t0 - g0, 0):max(t1 - g0, 0)] = True
    k_valid[(vi - g0)[vi - g0 < NW]] = True
    # a padded edge's target -1 is no free pose: its row joins no group
    row_pose, row_depth, rk = build_rows(
        ii_p, np.where(edge_valid, jj_p, -1), t0, t1, g0, NW)
    RMAX = rmax if rk.shape[1] <= rmax else _bucket(rk.shape[1],
                                                    RMAX_BUCKETS)
    rk_idx = np.full((NW, RMAX), -1, np.int64)
    rk_idx[:, :rk.shape[1]] = rk
    arrays = (ii_p, jj_p, edge_valid, k_valid, row_pose, row_depth, rk_idx,
              [g0], [t0], [t1])
    return PaddedShape(edges=E, window=NW, rmax=RMAX), arrays


def unpack_plan(take, shape: PaddedShape) -> BAPlan:
    """The plan from an int32 table vector, read by ``take(n)`` in
    ``build_plan_padded``'s packing order: indices long, masks bool, and
    g0, t0, t1 0-d tensors (as on the card, they stay there)."""
    E, NW, RMAX = shape
    ii, jj = take(E).long(), take(E).long()
    edge_valid = take(E) > 0
    k_valid = take(NW) > 0
    row_pose, row_depth = take(NW + E).long(), take(NW + E).long()
    rk_idx = take(NW * RMAX).long().reshape(NW, RMAX)
    g0, t0, t1 = (take(1).long()[0] for _ in range(3))
    return BAPlan(ii=ii, jj=jj, k_valid=k_valid, row_pose=row_pose,
                  row_depth=row_depth, rk_idx=rk_idx, g0=g0, t0=t0,
                  t1=t1), edge_valid


def ba_iterations(poses, disps, disps_sens, damping, intrinsics, target,
                  weight, plan: BAPlan, edge_valid=None, lm=1e-4, ep=0.1,
                  iters: int = 2, motion_only: bool = False):
    """``iters`` Gauss-Newton iterations; returns new (poses, disps).

    poses [B,7], disps/disps_sens/damping [B,h,w] are the keyframe buffers
    (disps_sens 0 where there is no sensor value); target/weight [E,2,HW]
    align with plan.ii/jj; intrinsics is the shared [4] vector. The inputs
    are not modified. The plan is exact (``build_plan``: g0, t0, t1 ints;
    the pose block is the t1 - t0 free poses) or padded (``unpack_plan``:
    g0, t0, t1 device scalars, ``edge_valid`` [E] marking the real edges,
    padded edges carry zero weight; the pose block is the window's size,
    its poses from t1 on held fixed as identity rows of the system).
    Either way the window (NW frames from g0) and the pose block have the
    plan's sizes and no value goes to the host, so that on a padded plan
    the iterations can be captured in a CUDA graph. ``motion_only`` keeps
    the disparities: the pose system alone, no Schur complement."""
    B, h, w = disps.shape
    hw = h * w
    NW = plan.k_valid.shape[0]
    n_free = plan.t1 - plan.t0
    P = n_free if isinstance(n_free, int) else NW
    dev = disps.device
    win = plan.g0 + torch.arange(NW, device=dev)
    ar = torch.arange(P, device=dev)
    pwin = plan.t0 + ar
    win_c, pwin_c = win.clamp(max=B - 1), pwin.clamp(max=B - 1)
    p_valid = ar < n_free
    ii, jj = plan.ii, plan.jj
    pi, pj = ii - plan.t0, jj - plan.t0
    ki = ii - plan.g0
    intr_all = intrinsics.expand(B, 4)
    eta = 0.2 * damping[win_c].reshape(NW, hw) + 1e-7
    sens_w = disps_sens[win_c].reshape(NW, hw)
    m_sens = (sens_w > 0).to(sens_w.dtype)
    kv = plan.k_valid[:, None]

    def retract(dx):
        cur = poses[pwin_c]
        return window_put(poses, pwin, torch.where(
            p_valid[:, None], se3.retr(cur, dx), cur))

    for _ in range(iters):
        t = edge_terms.linearize(poses, disps, intr_all, target, weight,
                                 ii, jj, edge_valid=edge_valid)
        Hii, Hij, Hji, Hjj, vi, vj = edge_terms.pose_blocks(t)
        A = _scatter_pose_blocks(torch.cat([Hii, Hij, Hji, Hjj]),
                                 torch.cat([pi, pi, pj, pj]),
                                 torch.cat([pi, pj, pi, pj]), P, n_free)
        v = _scatter_pose_vec(torch.cat([vi, vj]), torch.cat([pi, pj]), P,
                              n_free)
        if motion_only:
            poses = retract(_solve_masked(A, v.reshape(-1), p_valid, lm,
                                          ep).reshape(P, 6))
            continue

        Ei, Ej, Cz, bz = edge_terms.depth_blocks(t)
        C = Cz.new_zeros((NW, hw)).index_add_(0, ki, Cz)
        wz = bz.new_zeros((NW, hw)).index_add_(0, ki, bz)
        disps_w = disps[win_c].reshape(NW, hw)
        C = C + m_sens * ALPHA + (1.0 - m_sens) * eta
        wz = wz - m_sens * ALPHA * (disps_w - sens_w)
        Q = torch.where(kv & (C > 0), 1.0 / C, torch.zeros_like(C))

        S, S_rhs, Erows = _schur(Ei, Ej, Q, Q * wz, ki, plan, P)
        dx = _solve_masked(A - S, v.reshape(-1) - S_rhs, p_valid, lm,
                           ep).reshape(P, 6)

        # back-substitution per row; the EvT quirk: pose t0 (rp == 0) never
        # reaches the depths
        rp = plan.row_pose
        dx_row = dx[rp.clamp(min=0)] * ((rp > 0)[:, None])
        acc = Q.new_zeros((NW, hw)).index_add_(
            0, plan.row_depth, torch.bmm(dx_row[:, None], Erows)[:, 0])
        dz = Q * (wz - acc)

        new_poses = retract(dx)
        new_disps = window_put(disps, win, torch.where(
            kv, disps_w + dz, disps_w).reshape(NW, h, w))
        ok = torch.isfinite(dx).all() & torch.isfinite(dz).all()
        poses = torch.where(ok, new_poses, poses)
        disps = torch.where(ok, new_disps, disps)

    if not motion_only:
        disps = window_put(disps, win, disps[win_c].clamp(0.001, _DISP_MAX))
    return poses, disps
