"""Stereo tracking, written out plainly: the encoders on a rectified pair,
the stereo edge (i, i) that joins a keyframe's left view to its right view,
and the admission delta and one frontend update with its windowed bundle
adjustment over such edges, as DROID-SLAM defines them for ``--stereo``
(``droid_net.py``, ``motion_filter.py``, ``factor_graph.py``,
``geom/projective_ops.py``, ``src/droid_kernels.cu``).

A stereo edge (i, i) has the fixed relative pose of the rectified rig,
``G_ij = [-0.1, 0, 0, 0, 0, 0, 1]`` (``projective_ops.py:176-178``): frame
i's left pixels land in its right view, whose intrinsics are the left
view's. Its correlation volume is the left view's features against the
right view's. In the bundle adjustment its pose weights are zero (the
baseline moves no pose) and its disparity weights are kept
(``droid_kernels.cu:332,365``). Every other edge is the monocular one
(``tracking.py``, ``ba.py``).

Departures from DROID-SLAM, as the JAX package and its port keep them:
the baseline is 0.1 in every configuration (the EuRoC rig's ~0.11 is what
the evaluation's scale factor stands in for); the admission delta is the
left view against the last keyframe's left view, the context and the GRU
state come from the left view (``motion_filter.py`` feeds the context
encoder ``inputs[:, [0]]``); the frame distance of the keyframe test takes
no stereo override (its pairs are never (i, i)). The rest is
``tracking.py``'s and ``ba.py``'s, whose notes hold here.
"""

from __future__ import annotations

import torch

from . import droidnet, geometry as geo
from .ba import _solve
from .corr import lookup, pyramid
from .tracking import _damping_rows, admission_delta as _mono_delta

BASELINE = (-0.1, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0)


def encode_stereo(p, views, low=False):
    """uint8 BGR [2,H,W,3], left view first -> fmap [2,128,h,w] of both
    views, net = tanh and inp = relu of the left view's context
    [1,128,h,w]; float32. Each view is encoded alone (the feature
    encoder's instance norm is per image)."""
    fmap, net, inp = droidnet.encode(p, views[:1], low)
    right = droidnet.encode(p, views[1:], low)[0]
    return torch.cat([fmap, right]), net, inp


def admission_delta(p, anchor_views, views, low=False):
    """The motion filter's delta of a stereo frame: its left view against
    the keyframe's left view (uint8 [2,H,W,3] each)."""
    return _mono_delta(p, anchor_views[0], views[0], low)


def relative(poses, ii, jj):
    """G_ij = G_j G_i^-1, the rectified baseline where ii == jj."""
    Gij = geo.mul(poses[jj], geo.inv(poses[ii]))
    base = torch.tensor(BASELINE, dtype=Gij.dtype, device=Gij.device)
    return torch.where((ii == jj)[:, None], base, Gij)


def warp(poses, disps, intr, ii, jj, min_depth=geo.MIN_DEPTH,
         jacobians=False):
    """``geometry.warp`` with the stereo edges' fixed relative pose."""
    fx, fy, cx, cy = intr
    X0 = geo.iproj(disps[ii], intr)
    Gij = relative(poses, ii, jj)
    X1 = geo.act(Gij[:, None, None], X0)
    x, y, z, hc = X1.unbind(-1)
    zc = torch.where(z < 0.5 * min_depth, torch.ones_like(z), z)
    d = 1.0 / zc
    coords = torch.stack([fx * x * d + cx, fy * y * d + cy], dim=-1)
    valid = (z > min_depth) & (X0[..., 2] > min_depth)
    if not jacobians:
        return coords, valid, None
    d2, o = d * d, torch.zeros_like(d)
    Ju = torch.stack([fx * hc * d, o, -fx * x * hc * d2, -fx * x * y * d2,
                      fx * (1 + x * x * d2), -fx * y * d], dim=-1)
    Jv = torch.stack([o, fy * hc * d, -fy * y * hc * d2,
                      -fy * (1 + y * y * d2), fy * x * y * d2, fy * x * d],
                     dim=-1)
    Jj = torch.stack([Ju, Jv], dim=-2)
    Ji = -Jj @ geo.adj(Gij)[:, None, None]
    t = Gij[:, None, None, :3]
    Jz = torch.stack([fx * (t[..., 0] * d - t[..., 2] * x * d2),
                      fy * (t[..., 1] * d - t[..., 2] * y * d2)], dim=-1)
    return coords, valid, (Ji, Jj, Jz)


def edge_pyramid(fmap, ii, jj):
    """The correlation pyramid of each edge: the left view of ii against
    the left view of jj, or against its own right view where ii == jj
    (fmap [N,2,128,h,w])."""
    return pyramid(fmap[ii, 0], fmap[jj, (ii == jj).long()])


def bundle_adjust(poses, disps, damping, intr, target, weight, ii, jj, t0,
                  t1, lm, ep, iters=2):
    """``ba.bundle_adjust`` over stereo and monocular edges: the stereo
    edges' pose weights are zero, so they add only to their frame's
    disparity diagonal and right-hand side."""
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
    mono = (ii != jj).to(dt)[:, None, None, None]
    eta = 0.2 * damping.to(dt) + 1e-7
    edges_of = {k: [e for e in range(E) if ii_l[e] == k] for k in depth}
    pose_of = lambda f: f - t0 if t0 <= f < t1 else -1
    pose_t = lambda fs: torch.tensor([pose_of(f) for f in fs],
                                     device=poses.device)

    for _ in range(iters):
        coords, valid, (Ji, Jj, Jz) = warp(
            poses, disps, intr, ii, jj, geo.MIN_DEPTH_BA, jacobians=True)
        r = tgt - coords
        Wz = 0.001 * wgt * valid[..., None]     # the disparity weights
        W = Wz * mono                           # the pose weights
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
        C.index_add_(0, ii, (Wz * Jz * Jz).sum(-1))
        bz = torch.zeros_like(C).index_add_(0, ii, (Wz * r * Jz).sum(-1))
        Q = torch.where(is_depth[:, None, None] & (C > 0), 1.0 / C,
                        torch.zeros_like(C))

        # Schur complement, one depth frame at a time (``ba.py``)
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


def motion(poses, disps, intr, ii, jj, target):
    """``tracking.motion`` with the stereo warp."""
    E, (h, w) = len(ii), disps.shape[-2:]
    coords1, _, _ = warp(poses, disps, intr, ii, jj)
    grid = geo.coords_grid(h, w, coords1.dtype, coords1.device)
    resd = target.to(coords1.dtype).reshape(E, 2, h, w).permute(0, 2, 3, 1) \
        - coords1
    flow = torch.cat([coords1 - grid, resd], -1).clamp(-64.0, 64.0)
    return coords1, flow.permute(0, 3, 1, 2).float().contiguous()


def frame_update(p, s, image, intr, beta, motion_damping, iters1=3,
                 iters2=2, low=False):
    """``tracking.frame_update`` over stereo and monocular edges:
    ``image(r)`` is row r's pair, uint8 [2,H,W,3]; every row's features
    are both views' (``encode_stereo``), the stereo edges warp by the
    baseline, correlate against the right view and carry no pose weight.
    Returns (poses, disps, kf_dist after ``iters1``)."""
    poses, disps, damping = s["poses"], s["disps"], s["damping"]
    ii, jj = s["ii"], s["jj"]
    rows = torch.unique(torch.cat([ii, jj]))
    h, w = disps.shape[-2:]
    fmap = torch.zeros((len(poses), 2, 128, h, w), device=disps.device)
    net0 = torch.zeros((len(poses), 128, h, w), device=disps.device)
    inp = torch.zeros_like(net0)
    for r in rows.tolist():
        f, n, i = encode_stereo(p, image(r), low)
        fmap[r], net0[r], inp[r] = f, n[0], i[0]

    E = len(ii)
    new = s["new"]
    coords0, _, _ = warp(poses, disps, intr, ii, jj)
    tgt0 = coords0.reshape(E, -1, 2).transpose(1, 2)
    net = torch.where(new[:, None, None, None], net0[ii], s["net"].float())
    target = torch.where(new[:, None, None], tgt0.to(s["target"].dtype),
                         s["target"])
    pyr = edge_pyramid(fmap, ii, jj)
    del fmap

    first = s["first"]
    t0 = max(1 - first, int(ii.min()) + 1)
    t1 = int(max(ii.max(), jj.max())) + 1
    g0 = int(min(ii.min(), jj.min(), t0 - 1))
    m = (s["ii_in"] >= t0 - 3) & (s["jj_in"] >= t0 - 3)
    ii_b, jj_b = torch.cat([s["ii_in"][m], ii]), torch.cat([s["jj_in"][m], jj])
    kf = None
    n_it = iters1 + (iters2 if s["keep"] else 0)
    for it in range(n_it):
        coords1, flow = motion(poses, disps, intr, ii, jj, target)
        corr = lookup(pyr, coords1).float()
        net, delta, wgt = droidnet.update(p, net, inp[ii], corr, flow, low)
        target = (coords1.permute(0, 3, 1, 2) + delta.to(coords1.dtype)) \
            .reshape(E, 2, -1)
        weight = wgt.reshape(E, 2, -1)
        damping = _damping_rows(p, net, ii, g0, t1 - g0, damping, low)
        poses, disps = bundle_adjust(
            poses, disps, damping, intr,
            torch.cat([s["target_in"][m].to(target.dtype), target]),
            torch.cat([s["weight_in"][m].to(weight.dtype), weight]),
            ii_b, jj_b, t0, t1, lm=1e-4, ep=0.1, iters=2)
        if it == iters1 - 1:
            t1f = s["t1"]
            kf = geo.frame_distance(
                poses, disps, intr, torch.tensor([t1f - 4], device=ii.device),
                torch.tensor([t1f - 2], device=ii.device), beta)[0]
    if s["keep"]:
        t = s["t1"]
        vel = geo.log(geo.mul(poses[t - 1], geo.inv(poses[t - 2])))
        poses = poses.clone()
        disps = disps.clone()
        poses[t] = geo.mul(geo.exp(motion_damping * vel), poses[t - 1])
        disps[t] = torch.quantile(disps[t - 3:t - 1], 0.5)
    return poses, disps, kf
