"""One pass of the global bundle adjustment, written out plainly, as
DROID-SLAM's ``droid_backend.py`` and ``factor_graph.py`` define it: the
proximity proposal over every pair of keyframes (the frame distance,
greedy non-maximum suppression), then ``steps`` x (the update operator over
every edge, correlating the features on the fly, and two Gauss-Newton
iterations over all poses but the first and every disparity)."""

from __future__ import annotations

import numpy as np
import torch

from . import droidnet, geometry as geo
from .ba import bundle_adjust
from .corr import lookup, pyramid
from .tracking import motion

PAIR_CHUNK = 8192


def distances(poses, disps, intr, t, beta):
    """The frame distance of every pair (i, j) of [0, t)^2, i-major."""
    ii, jj = torch.meshgrid(torch.arange(t, device=poses.device),
                            torch.arange(t, device=poses.device),
                            indexing="ij")
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    return torch.cat([geo.frame_distance(poses, disps, intr,
                                         ii[s:s + PAIR_CHUNK],
                                         jj[s:s + PAIR_CHUNK], beta)
                      for s in range(0, len(ii), PAIR_CHUNK)])


def propose(dist, t, rad, nms, thresh, max_factors):
    """The edges (i, j) of a fresh graph over [0, t): every pair at most
    ``rad`` + 1 apart, both ways, then the closest remaining pairs under
    ``thresh``, each suppressing its ``nms`` neighbourhood, while the
    edges number at most ``max_factors``. ``dist`` [t*t] i-major."""
    d = np.asarray(dist, np.float64).copy()
    ii, jj = np.meshgrid(np.arange(t), np.arange(t), indexing="ij")
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    d[ii - rad < jj] = np.inf
    d[d > 100] = np.inf

    def suppress(i, j):
        n = max(min(abs(i - j) - 2, nms), 0)
        for di in range(-nms, nms + 1):
            for dj in range(-nms, nms + 1):
                if abs(di) + abs(dj) <= n:
                    i1, j1 = i + di, j + dj
                    if 0 <= i1 < t and 0 <= j1 < t:
                        d[i1 * t + j1] = np.inf

    es = []
    for i in range(t):
        for j in range(max(i - rad - 1, 0), i):
            es += [(i, j), (j, i)]
            d[i * t + j] = np.inf
    for k in np.argsort(d, kind="stable"):
        if d[k] > thresh:
            continue
        if max_factors > 0 and len(es) > max_factors:
            break
        i, j = int(ii[k]), int(jj[k])
        es += [(i, j), (j, i)]
        suppress(i, j)
    out, seen = [], set()
    for e in es:
        if e not in seen:
            seen.add(e)
            out.append(e)
    return np.asarray(out, np.int64).reshape(-1, 2)


def global_ba(p, poses, disps, damping, fmaps, nets, inps, intr, ii, jj,
              steps=2, low=False):
    """``steps`` x (the update operator over every edge (ii, jj), then two
    Gauss-Newton iterations with free poses [1, t)) from fresh edges: GRU
    state from ``nets``, targets the current reprojection, weights zero.
    fmaps/nets/inps [t,128,h,w]; returns (poses, disps)."""
    t = len(poses)
    E = len(ii)
    coords0, _, _ = geo.warp(poses, disps, intr, ii, jj)
    target = coords0.reshape(E, -1, 2).transpose(1, 2)
    weight = torch.zeros_like(target, dtype=torch.float32)
    net = nets[ii].float()
    for _ in range(steps):
        damping = damping.clone()
        new_t, new_w = torch.empty_like(target), torch.empty_like(weight)
        # blocks of 8 source frames: each frame's damping aggregates
        # all of its edges
        for f0 in range(0, t, 8):
            sel = torch.nonzero((ii >= f0) & (ii < f0 + 8))[:, 0]
            if not len(sel):
                continue
            i, j = ii[sel], jj[sel]
            coords1, flow = motion(poses, disps, intr, i, j, target[sel])
            corr = lookup(pyramid(fmaps[i].float(), fmaps[j].float()),
                          coords1).float()
            n, delta, wgt = droidnet.update(p, net[sel], inps[i].float(),
                                            corr, flow, low)
            net[sel] = n
            new_t[sel] = (coords1.permute(0, 3, 1, 2)
                          + delta.to(coords1.dtype)).reshape(len(sel), 2, -1)
            new_w[sel] = wgt.reshape(len(sel), 2, -1)
            eta = droidnet.damping(p, n, i - f0, 8, low)
            fr = torch.unique(i)
            damping[fr] = eta[fr - f0].to(damping.dtype)
        target, weight = new_t, new_w
        poses, disps = bundle_adjust(poses, disps, damping, intr, target,
                                     weight, ii, jj, 1, t, lm=1e-5, ep=1e-2,
                                     iters=2)
    return poses, disps
