"""The update operator's pass over a batch of edges, and a new edge's
first state: one home for the chain reproject -> correlation lookup ->
update operator -> target that ``state/graph.py`` (the strict path, the
frame path, the global BA's sweep) and ``parallel/`` run. It imports
neither of them.
"""

from __future__ import annotations

import torch

from ..geom import projective as pops
from ..models import nets
from ..ops import corr as corr_ops

_BF16 = torch.bfloat16


def motion_features(poses, disps, intrinsics, ii_t, jj_t, target):
    """coords1 [E,h,w,2] of the edges (ii, jj) at the given poses and
    disparities, and the update operator's motion features [E,4,h,w]
    bf16: flow from the identity grid and residual to the target."""
    E, (h, w) = len(ii_t), disps.shape[-2:]
    coords1, _, _ = pops.projective_transform(poses, disps, intrinsics, ii_t,
                                              jj_t)
    coords0 = pops.coords_grid(h, w, device=coords1.device)
    resd = target.reshape(E, 2, h, w).permute(0, 2, 3, 1) - coords1
    motn = torch.cat([coords1 - coords0, resd], dim=-1).clamp(-64.0, 64.0)
    return coords1, motn.to(_BF16).permute(0, 3, 1, 2)


def corr_nchw(corr, h, w):
    """Lookup output [E,HW,196] f32 -> the corr encoder's [E,196,h,w]
    bf16."""
    return corr.to(_BF16).transpose(1, 2).reshape(corr.shape[0], -1, h, w)


def target_weight(coords1, delta, weight):
    """The update's new target and weight [E,2,HW] f32."""
    E, h, w = coords1.shape[:3]
    return ((coords1.permute(0, 3, 1, 2) + delta.float()).reshape(E, 2, h * w),
            weight.float().reshape(E, 2, h * w))


def edge_update(params, poses, disps, intrinsics, ii, jj, net, target,
                lookup, inp=None, pre=None, agg=None, num_frames=None,
                fused_epilogue=False, merged=None, compute_upmask=False):
    """One update-operator pass over the edges (ii, jj) with GRU state
    ``net`` and targets ``target``. ``lookup``: coords1 [E,HW,2] f32 ->
    the correlation [E,HW,196] f32, from the caller's layout. The rest as
    ``nets.update_module``, whose ``ii`` is ``agg``.

    -> (net, target [E,2,HW] f32, weight [E,2,HW] f32, eta, upmask);
    eta and upmask None without ``agg``."""
    E, (h, w) = len(ii), disps.shape[-2:]
    coords1, motn = motion_features(poses, disps, intrinsics, ii, jj, target)
    corr = lookup(coords1.reshape(E, h * w, 2))
    out = nets.update_module(params, net, inp, corr_nchw(corr, h, w), motn,
                             ii=agg, num_frames=num_frames, pre=pre,
                             fused_epilogue=fused_epilogue,
                             compute_upmask=compute_upmask, merged=merged)
    net, delta, weight = out[:3]
    eta, upmask = out[3:] if agg is not None else (None, None)
    return (net, *target_weight(coords1, delta, weight), eta, upmask)


def new_edge_state(video, ii, jj, view2, with_volumes):
    """New edges' first state: (net from the video, the reprojection as
    target [E,2,HW] f32, weight 0, and with ``with_volumes`` the bf16
    volume pyramid against view ``view2`` [E] of jj, else []). Reads
    nothing back to the host."""
    v, hw = video, video.h * video.w
    coords, _, _ = pops.projective_transform(v.poses, v.disps, v.intrinsics,
                                             ii, jj)
    target0 = coords.reshape(len(ii), hw, 2).transpose(1, 2)
    vols = []
    if with_volumes:
        vols = [q.to(_BF16) for q in corr_ops.build_pyramid(
            v.fmaps[ii, 0], v.fmaps[jj, view2])]
    return v.nets[ii], target0, torch.zeros_like(target0), vols
