"""DroidNet's training forward: the unrolled update operator and two
differentiable dense-BA steps per iteration.

Counterpart of ``droid_slam_tpu/models/droidnet.py`` for one sample, on
NCHW features. Each iteration detaches the state (poses, disparities,
coordinates and target), looks up the correlation windows, runs the update
operator, takes two BA steps and records the reprojection residual. The
histories feed the list-form losses (``train/losses.py``); the trainer runs
the same iteration under a checkpoint (``train/trainer.py::sample_loss``).
"""

from __future__ import annotations

import torch

from ..ba import dense
from ..geom import projective as pops
from ..ops import corr as corr_ops
from . import nets


def prepare(params, images, Gs0, disps0, intrinsics, ii, jj, compute_dtype):
    """Features, context and correlation pyramid of one sample, and the
    starting coordinates: (net [E,128,h,w], inp, pyramid, coords0 [h,w,2],
    coords1 [E,h,w,2]). The volumes are built in f32 from the features."""
    fmaps, net_f, inp_f = nets.extract_features(params, images,
                                                compute_dtype=compute_dtype)
    pyramid = corr_ops.build_pyramid(fmaps[ii].float(), fmaps[jj].float())
    h, w = disps0.shape[-2:]
    coords0 = pops.coords_grid(h, w, device=disps0.device)
    coords1, _, _ = pops.projective_transform(Gs0, disps0, intrinsics, ii, jj)
    return net_f[ii], inp_f[ii], pyramid, coords0, coords1


def iteration(params, net, inp, pyramid, coords0, Gs, disps, coords1, target,
              intrinsics, ii, jj, fixedp, compute_dtype):
    """One unrolled iteration from the detached state; returns (net, Gs,
    disps, coords1, target, residual [E,h,w,2], upmask)."""
    N = disps.shape[0]
    E, h, w, _ = coords1.shape
    hw = h * w
    slots = torch.arange(E, device=coords1.device)
    corr = corr_ops.lookup_pyramid_plain(pyramid, slots,
                                         coords1.reshape(E, hw, 2))
    corr = corr.transpose(1, 2).reshape(E, -1, h, w)
    motn = torch.cat([coords1 - coords0, target - coords1], dim=-1)
    motn = motn.clamp(-64.0, 64.0).permute(0, 3, 1, 2)

    net, delta, weight, eta, upmask = nets.update_module(
        params, net, inp, corr.to(compute_dtype), motn.to(compute_dtype),
        ii=ii, num_frames=N, compute_upmask=True)
    target = coords1 + delta.float().permute(0, 2, 3, 1)

    tgt_ba = target.reshape(E, hw, 2).transpose(1, 2)
    wgt_ba = weight.float().reshape(E, 2, hw)
    for _ in range(2):
        Gs, disps = dense.ba_step(tgt_ba, wgt_ba, eta.float().reshape(N, hw),
                                  Gs, disps, intrinsics, ii, jj,
                                  fixedp=fixedp, ep=0.1, lm=1e-4)
    coords1, valid, _ = pops.projective_transform(Gs, disps, intrinsics,
                                                  ii, jj)
    return net, Gs, disps, coords1, target, valid * (target - coords1), upmask


def forward(params, images, Gs0, disps0, intrinsics, ii, jj,
            num_steps: int = 12, fixedp: int = 2,
            compute_dtype=torch.bfloat16):
    """images [N,H,W,3] uint8 BGR; Gs0 [N,7]; disps0 [N,h,w]; intrinsics
    [N,4] at 1/8 scale; ii/jj [E]. Returns (Gs_list, disp_up_list,
    residual_list), the disparities convex-upsampled to full resolution."""
    net, inp, pyramid, coords0, coords1 = prepare(
        params, images, Gs0, disps0, intrinsics, ii, jj, compute_dtype)
    Gs, disps, target = Gs0, disps0, coords1
    Gs_list, disp_list, residual_list = [], [], []
    for _ in range(num_steps):
        net, Gs, disps, coords1, target, resid, upmask = iteration(
            params, net, inp, pyramid, coords0, Gs.detach(), disps.detach(),
            coords1.detach(), target.detach(), intrinsics, ii, jj, fixedp,
            compute_dtype)
        residual_list.append(resid)
        Gs_list.append(Gs)
        disp_list.append(nets.upsample_disp(disps, upmask))
    return Gs_list, disp_list, residual_list
