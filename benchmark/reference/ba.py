"""Dense bundle adjustment, written out plainly: Gauss-Newton over the free
poses [t0, t1) and the per-pixel disparities of the depth frames (the
frames of ii and [t0, t1)), the disparities eliminated by the Schur
complement one depth frame at a time, the pose system solved by Cholesky.

The conventions are DROID-SLAM's (``droid_kernels.cu``, as the JAX package
and its port keep them): weights scaled by 0.001 and zero where a point
lands within 0.25 of the camera; the damping 0.2 * eta + 1e-7 on the
disparities; ``ep + lm * diag`` added to the pose system after the Schur
subtraction; the back-substitution leaves out the first free pose (the
reference's ``idx <= 0`` test); a step with a non-finite update is
dropped, a system that does not factor gives a zero step; the
disparities are clamped to [0.001, 1e6] at the end."""

from __future__ import annotations

import torch

from . import geometry as geo


def _solve(M, b):
    L, info = torch.linalg.cholesky_ex(M)
    if int(info) != 0 or not bool(torch.isfinite(L).all()):
        return torch.zeros_like(b)
    x = torch.cholesky_solve(b[:, None], L)[:, 0]
    return x + torch.cholesky_solve((b - M @ x)[:, None], L)[:, 0]


def bundle_adjust(poses, disps, damping, intr, target, weight, ii, jj, t0,
                  t1, lm, ep, iters=2):
    """poses [N,7], disps and damping [N,h,w] (rows are frames), target
    and weight [E,2,h*w], ii/jj long [E]; free poses [t0, t1). Returns the
    new (poses, disps); computes in the dtype of ``poses``."""
    dt = poses.dtype
    N, h, w = disps.shape
    E = len(ii)
    ii_l, jj_l = ii.tolist(), jj.tolist()
    P = t1 - t0
    g0 = min(min(ii_l), min(jj_l), t0)
    end = max(t1, max(ii_l) + 1, max(jj_l) + 1)
    depth = sorted(set(range(t0, t1)) | set(ii_l))
    is_depth = torch.zeros(N, dtype=torch.bool, device=disps.device)
    is_depth[depth] = True
    tgt = target.to(dt).reshape(E, 2, h, w).permute(0, 2, 3, 1)
    wgt = weight.to(dt).reshape(E, 2, h, w).permute(0, 2, 3, 1)
    eta = 0.2 * damping.to(dt) + 1e-7
    edges_of = {k: [e for e in range(E) if ii_l[e] == k] for k in depth}
    pose_of = lambda f: f - t0 if t0 <= f < t1 else -1
    pose_t = lambda fs: torch.tensor([pose_of(f) for f in fs],
                                     device=poses.device)

    for _ in range(iters):
        coords, valid, (Ji, Jj, Jz) = geo.warp(
            poses, disps, intr, ii, jj, geo.MIN_DEPTH_BA, jacobians=True)
        r = tgt - coords
        W = 0.001 * wgt * valid[..., None]
        JiW, JjW = Ji * W[..., None], Jj * W[..., None]
        blk = {"ii": torch.einsum("ehwcd,ehwcf->edf", JiW, Ji),
               "ij": torch.einsum("ehwcd,ehwcf->edf", JiW, Jj),
               "jj": torch.einsum("ehwcd,ehwcf->edf", JjW, Jj)}
        vi = torch.einsum("ehwcd,ehwc->ed", JiW, r)
        vj = torch.einsum("ehwcd,ehwc->ed", JjW, r)
        A = torch.zeros(P, P, 6, 6, dtype=dt, device=poses.device)
        v = torch.zeros(P, 6, dtype=dt, device=poses.device)
        pi, pj = pose_t(ii_l), pose_t(jj_l)
        for a, b, H in ((pi, pi, blk["ii"]), (pj, pj, blk["jj"]),
                        (pi, pj, blk["ij"]), (pj, pi, blk["ij"].mT)):
            m = (a >= 0) & (b >= 0)
            A.index_put_((a[m], b[m]), H[m], accumulate=True)
        for a, g in ((pi, vi), (pj, vj)):
            v.index_add_(0, a[a >= 0], g[a >= 0])
        Ei = torch.einsum("ehwcd,ehwc->ehwd", JiW, Jz)
        Ej = torch.einsum("ehwcd,ehwc->ehwd", JjW, Jz)
        C = eta.clone()
        C.index_add_(0, ii, (W * Jz * Jz).sum(-1))
        bz = torch.zeros_like(C).index_add_(0, ii, (W * r * Jz).sum(-1))
        Q = torch.where(is_depth[:, None, None] & (C > 0), 1.0 / C,
                        torch.zeros_like(C))

        # Schur complement, one depth frame at a time: its rows are the
        # frame's own pose (the i-sides of its edges summed) and each
        # edge's target pose
        S = torch.zeros_like(A)
        s_rhs = torch.zeros_like(v)
        rows_of = {}
        for k in depth:
            es = edges_of[k]
            rows = [(pose_of(k), Ei[es].sum(0) if es else None)]
            rows += [(pose_of(jj_l[e]), Ej[e]) for e in es]
            rows = [(p, R) for p, R in rows if p >= 0 and R is not None]
            rows_of[k] = rows
            if not rows:
                continue
            R = torch.stack([R for _, R in rows]).reshape(len(rows), -1, 6)
            RQ = R * Q[k].reshape(1, -1, 1)
            G = torch.einsum("ard,bre->abde", RQ, R)
            p = torch.tensor([q for q, _ in rows], device=poses.device)
            n = len(rows)
            S.index_put_((p[:, None].expand(n, n).reshape(-1),
                          p[None, :].expand(n, n).reshape(-1)),
                         G.reshape(-1, 6, 6), accumulate=True)
            s_rhs.index_add_(0, p, torch.einsum("ard,r->ad", RQ,
                                                bz[k].reshape(-1)))

        M = (A - S).permute(0, 2, 1, 3).reshape(6 * P, 6 * P)
        M = M + torch.diag(ep + lm * torch.diagonal(M))
        dx = _solve(M, (v - s_rhs).reshape(-1)).reshape(P, 6)

        dz = torch.zeros_like(C)
        for k in depth:
            back = [(p, R) for p, R in rows_of[k] if p > 0]
            acc = sum((R.reshape(-1, 6) @ dx[p] for p, R in back),
                      torch.zeros(h * w, dtype=dt, device=poses.device))
            dz[k] = Q[k] * (bz[k] - acc.reshape(h, w))
        if not (bool(torch.isfinite(dx).all())
                and bool(torch.isfinite(dz).all())):
            continue
        poses = poses.clone()
        poses[t0:t1] = geo.retr(poses[t0:t1], dx)
        disps = torch.where(is_depth[:, None, None], disps + dz, disps)
    disps = disps.clone()
    disps[g0:end] = disps[g0:end].clamp(0.001, 1e6)
    return poses, disps
