"""The tracker's work on one frame, written out plainly: the motion filter's
admission delta, and one frontend update with its windowed bundle
adjustment, as DROID-SLAM's ``motion_filter.py``, ``factor_graph.py`` and
``droid_frontend.py`` define them.

``frame_update`` follows the tracker from its own state before the frame:
the edges the frontend chose (its proposal and eviction are bookkeeping
over the whole history), their GRU states, targets and weights, and the
poses, disparities and damping of the window. The features of every frame
are computed again here from the frames' images."""

from __future__ import annotations

import torch

from . import droidnet, geometry as geo
from .ba import bundle_adjust
from .corr import lookup, pyramid


def motion(poses, disps, intr, ii, jj, target):
    """coords1 [E,h,w,2] and the update operator's flow input [E,4,h,w]:
    the flow from the pixel grid and the residual to the target."""
    E, (h, w) = len(ii), disps.shape[-2:]
    coords1, _, _ = geo.warp(poses, disps, intr, ii, jj)
    grid = geo.coords_grid(h, w, coords1.dtype, coords1.device)
    resd = target.to(coords1.dtype).reshape(E, 2, h, w).permute(0, 2, 3, 1) \
        - coords1
    flow = torch.cat([coords1 - grid, resd], -1).clamp(-64.0, 64.0)
    return coords1, flow.permute(0, 3, 1, 2).float().contiguous()


def admission_delta(p, anchor_image, image, low=False):
    """The mean |flow correction| of one update from zero flow of
    ``image`` against the keyframe ``anchor_image`` (uint8 [H,W,3])."""
    fa, na, ia = droidnet.encode(p, anchor_image[None], low)
    ff, _, _ = droidnet.encode(p, image[None], low)
    h, w = ff.shape[-2:]
    grid = geo.coords_grid(h, w, torch.float32, ff.device)[None]
    corr = lookup(pyramid(fa, ff), grid).float()
    flow = torch.zeros((1, 4, h, w), device=ff.device)
    _, delta, _ = droidnet.update(p, na, ia, corr, flow, low)
    return delta.norm(dim=1).mean()


def _damping_rows(p, net, ii, g0, n, damping, low):
    eta = droidnet.damping(p, net, ii - g0, n, low)
    frames = torch.unique(ii)
    damping = damping.clone()
    damping[frames] = eta[frames - g0].to(damping.dtype)
    return damping


def frame_update(p, s, image, intr, beta, motion_damping, iters1=3,
                 iters2=2, low=False):
    """One frontend update from the tracker's state ``s`` (rows are frames
    counted from the snapshot's first row): ``poses``, ``disps``,
    ``damping``; the active edges ``ii``, ``jj``, ``new`` (edges added by
    this update), and for the others their ``net``, ``target``,
    ``weight``; the inactive edges ``ii_in``, ``jj_in`` with their
    ``target_in``, ``weight_in``; ``t1`` (the frontend's newest frame plus
    one), ``keep`` (the keyframe stays: ``iters2`` more iterations and the
    motion model for frame t1; the tracker's own decision is followed) and
    ``first`` (the absolute number of row 0, for the first-pose rule).
    ``image(r)``: row r's frame, uint8 [H,W,3]. Returns (poses, disps,
    kf_dist after ``iters1``)."""
    poses, disps, damping = s["poses"], s["disps"], s["damping"]
    ii, jj = s["ii"], s["jj"]
    rows = torch.unique(torch.cat([ii, jj]))
    fmap = torch.zeros((len(poses), 128) + disps.shape[-2:],
                       device=disps.device)
    net0, inp = torch.zeros_like(fmap), torch.zeros_like(fmap)
    for r in rows.tolist():
        fmap[r], net0[r], inp[r] = (x[0] for x in droidnet.encode(
            p, image(r)[None], low))

    E = len(ii)
    new = s["new"]
    coords0, _, _ = geo.warp(poses, disps, intr, ii, jj)
    tgt0 = coords0.reshape(E, -1, 2).transpose(1, 2)
    net = torch.where(new[:, None, None, None], net0[ii], s["net"].float())
    target = torch.where(new[:, None, None], tgt0.to(s["target"].dtype),
                         s["target"])
    weight = torch.where(new[:, None, None], torch.zeros_like(s["weight"]),
                         s["weight"])
    pyr = pyramid(fmap[ii], fmap[jj])

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
