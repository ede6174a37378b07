"""Training losses: the geodesic pose loss, the residual loss and the flow
loss, each weighted by gamma^(n-1-i) over the iteration history.

Counterpart of ``droid_slam_tpu/train/losses.py``. The ``*_step`` functions
are one iterate's unweighted term (the trainer sums them inside its
checkpointed iterations); the ``*_loss`` functions take history lists;
metrics are dicts of scalar tensors of the final iterate.
"""

from __future__ import annotations

import math

import torch

from ..geom import projective as pops
from ..lie import se3, sim3


def fit_scale(dP, dG):
    """Least-squares relative scale between two sets of edge translations
    [..., E, 7], with no gradient through the translations."""
    t1 = dP[..., :3].detach().reshape(dP.shape[:-2] + (-1,))
    t2 = dG[..., :3].detach().reshape(dG.shape[:-2] + (-1,))
    return (t1 * t2).sum(-1) / ((t2 * t2).sum(-1) + 1e-8)


def _edge_dG(dP, Gs, ii, jj, do_scale):
    """The estimate's relative poses over the edges, optionally scaled to
    the ground truth's translations (the monocular gauge)."""
    dG = se3.mul(Gs[jj], se3.inv(Gs[ii]))
    if do_scale:
        s = fit_scale(dP[None], dG[None])[0]
        dG = torch.cat([dG[..., :3] * s, dG[..., 3:]], dim=-1)
    return dG


def geodesic_step(dP, Gs, ii, jj, do_scale=True):
    """Unweighted geodesic term of one iterate (dP: ground-truth relative
    poses over the edges)."""
    d = se3.log(se3.mul(_edge_dG(dP, Gs, ii, jj, do_scale), se3.inv(dP)))
    return (torch.linalg.norm(d[..., :3], dim=-1).mean()
            + torch.linalg.norm(d[..., 3:6], dim=-1).mean())


def geodesic_metrics(dP, Gs, ii, jj, do_scale=True):
    """Rotation (degrees) and translation errors of an iterate, and the
    shares of edges under 0.1 degree and 0.01 ("bad_rot", "bad_tr" keep
    the JAX package's names)."""
    dG = _edge_dG(dP, Gs, ii, jj, do_scale)
    dE = sim3.from_se3(se3.mul(dG, se3.inv(dP)))
    r_err = (180.0 / math.pi) * torch.linalg.norm(
        se3.so3_log(dE[..., 3:7]), dim=-1)
    t_err = torch.linalg.norm(dE[..., :3], dim=-1)
    return {
        "rot_error": r_err.mean(),
        "tr_error": t_err.mean(),
        "bad_rot": (r_err < 0.1).float().mean(),
        "bad_tr": (t_err < 0.01).float().mean(),
    }


def geodesic_loss(Ps, Gs_list, ii, jj, gamma=0.9, do_scale=True):
    """Ps [N,7] ground truth, Gs_list: [N,7] estimates, oldest first."""
    dP = se3.mul(Ps[jj], se3.inv(Ps[ii]))
    n = len(Gs_list)
    total = sum(gamma ** (n - i - 1) * geodesic_step(dP, Gs, ii, jj, do_scale)
                for i, Gs in enumerate(Gs_list))
    return total, geodesic_metrics(dP, Gs_list[-1], ii, jj, do_scale)


def residual_loss(residuals, gamma=0.9):
    n = len(residuals)
    total = sum(gamma ** (n - i - 1) * r.abs().mean()
                for i, r in enumerate(residuals))
    return total, {"residual": total}


def adjacent_pairs(N, device=None):
    """Edge lists of the frame pairs with |i - j| == 1, in (i, j) order."""
    pairs = [(a, b) for a in range(N) for b in range(N) if abs(a - b) == 1]
    ii, jj = zip(*pairs)
    return (torch.tensor(ii, device=device), torch.tensor(jj, device=device))


def flow_gt(Ps, disps, intrinsics, ii, jj):
    """Ground-truth endpoints of the induced flow over the adjacent pairs,
    and their validity (which also needs a positive disparity)."""
    coords0, val0, _ = pops.projective_transform(Ps, disps, intrinsics, ii, jj)
    return coords0, val0 * (disps[ii] > 0).to(val0.dtype)[..., None]


def flow_step(coords0, val0, Gs, disp_est, intrinsics, ii, jj):
    """Unweighted flow-EPE term of one iterate, and (epe, v) for the
    metrics. The EPE's square root is masked so that an exactly zero
    difference gives a zero gradient, not 0 * NaN."""
    coords1, val1, _ = pops.projective_transform(Gs, disp_est, intrinsics,
                                                 ii, jj)
    v = (val0 * val1)[..., 0]
    diff = coords1 - coords0
    sq = (diff * diff).sum(-1)
    pos = sq > 0
    epe = torch.where(pos, v * torch.sqrt(torch.where(pos, sq,
                                                      torch.ones_like(sq))),
                      torch.zeros_like(sq))
    return epe.mean(), epe, v


def flow_metrics(epe, v):
    """Masked EPE and the share of valid pixels under 1 px."""
    ok = v > 0.5
    denom = ok.sum().clamp(min=1)
    return {
        "f_error": torch.where(ok, epe, torch.zeros_like(epe)).sum() / denom,
        "1px": (ok & (epe < 1.0)).float().sum() / denom,
    }


def flow_loss(Ps, disps, poses_est, disps_est, intrinsics, gamma=0.9):
    """EPE of the flow induced between adjacent frames. Ps [N,7] and disps
    [N,H,W] ground truth; poses_est and disps_est history lists."""
    ii, jj = adjacent_pairs(Ps.shape[0], Ps.device)
    coords0, val0 = flow_gt(Ps, disps, intrinsics, ii, jj)
    n = len(poses_est)
    total = 0.0
    for i in range(n):
        term, epe, v = flow_step(coords0, val0, poses_est[i], disps_est[i],
                                 intrinsics, ii, jj)
        total = total + gamma ** (n - i - 1) * term
    return total, flow_metrics(epe, v)
