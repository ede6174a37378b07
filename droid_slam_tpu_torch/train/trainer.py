"""The trainer on one GPU: DroidNet's unrolled forward with in-loop losses
under a checkpoint per iteration, random restarts, and the optimizer chain.

Counterpart of ``droid_slam_tpu/train/trainer.py``. A step runs the samples
of the batch one at a time, each backward scaled by 1/B, so the gradient is
the batch mean that JAX's ``vmap`` takes; restarts from the detached last
estimates add their gradients to it; then one optimizer update:
non-finite entries zeroed -> clip by global norm -> + weight_decay * p ->
Adam -> the one-cycle learning rate, in that order, as the JAX package's
optax chain (``trainer.py:72-83``). With a data-parallel group (``dp``,
``parallel/mesh.py``) each rank steps on its block of the global batch,
and the gradients and metrics are averaged over the ranks before the
update (JAX's ``pmean``, ``trainer.py:248-253``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from ..lie import se3
from ..models import droidnet, nets
from ..models import weights as weights_io
from ..parallel import mesh as pmesh
from ..slam.droid import f32_matmuls
from . import losses

MAX_RESTARTS = 4
METRIC_KEYS = ("rot_error", "tr_error", "bad_rot", "bad_tr", "residual",
               "f_error", "1px", "loss")


@dataclasses.dataclass
class TrainConfig:
    lr: float = 2.5e-4
    steps: int = 250_000
    iters: int = 15
    clip: float = 2.5
    n_frames: int = 7
    w1: float = 10.0   # geodesic
    w2: float = 0.01   # residual
    w3: float = 0.05   # flow
    edges: int = 24
    restart_prob: float = 0.2
    weight_decay: float = 1e-5
    pct_start: float = 0.01
    fmin: float = 8.0
    fmax: float = 96.0


def onecycle_lr(cfg: TrainConfig, count: int) -> float:
    """``optax.linear_onecycle_schedule(cfg.steps, cfg.lr, cfg.pct_start,
    pct_final=1.0, div_factor=25, final_div_factor=1e4)`` at ``count``:
    linear from lr/25 to lr over the first int(pct_start * steps) steps,
    then linear to lr * 1e-4 at ``steps``, and that value after. optax
    divides 0 by 0 where the warm-up rounds to zero steps (steps < 100)
    and returns NaN at every count; here the empty interval is skipped."""
    bounds = [0, int(cfg.pct_start * cfg.steps), cfg.steps]
    values = [cfg.lr / 25.0, cfg.lr, cfg.lr * 1e-4]
    for k in range(2):
        lo, hi = bounds[k], bounds[k + 1]
        if lo <= count < hi:
            return values[k] + (values[k + 1] - values[k]) * (count - lo) / (
                hi - lo)
    return values[-1]


class Optimizer:
    """The optax chain of the JAX trainer on a dict of leaf tensors. The
    count is the number of updates applied: the schedule reads it."""

    def __init__(self, params: dict, cfg: TrainConfig):
        self.cfg = cfg
        self.names = sorted(params)
        self.params = [params[k] for k in self.names]
        self.adam = torch.optim.Adam(self.params, lr=cfg.lr,
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=cfg.weight_decay)
        self.count = 0

    def step(self, grads: dict):
        """One update from ``grads`` {name: tensor}; returns the share of
        non-finite gradient entries."""
        g = [grads[k] for k in self.names]
        bad = torch.stack([(~torch.isfinite(x)).sum() for x in g]).sum()
        g = [torch.where(torch.isfinite(x), x, torch.zeros_like(x))
             for x in g]
        norm = torch.sqrt(sum((x * x).sum() for x in g))
        keep = norm < self.cfg.clip
        for p, x in zip(self.params, g):
            p.grad = torch.where(keep, x, x / norm * self.cfg.clip)
        for group in self.adam.param_groups:
            group["lr"] = onecycle_lr(self.cfg, self.count)
        self.adam.step()
        self.count += 1
        for p in self.params:
            p.grad = None
        return float(bad) / sum(x.numel() for x in g)

    def state_dict(self):
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state):
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])


def make_optimizer(params: dict, cfg: TrainConfig) -> Optimizer:
    return Optimizer(params, cfg)


def default_init(Ps, disps_gt):
    """The unroll's start: frame 0 at its ground-truth pose, every other
    frame at frame 1's; disparities 1 at 1/8 resolution."""
    N = Ps.shape[0]
    Gs0 = torch.cat([Ps[:1], Ps[1:2].expand(N - 1, 7)])
    return Gs0, torch.ones_like(disps_gt[:, 3::8, 3::8])


def sample_loss(params, images, Ps, disps_gt, intrinsics, Gs0, disps0, ii,
                jj, cfg: TrainConfig, num_steps: int, gamma: float = 0.9,
                compute_dtype=torch.bfloat16):
    """One training sample: images [N,H,W,3] uint8, Ps [N,7] world-to-camera
    ground truth, disps_gt [N,H,W], intrinsics [N,4] at full resolution,
    Gs0/disps0 the unroll's start. Each iteration runs under one
    checkpoint (its activations are recomputed in the backward) and adds
    its gamma^(n-1-i)-weighted terms to the loss.

    Returns (loss, (metrics of the final iterate, (Gs_f, disps_f))), the
    finals detached, disparities at 1/8 resolution."""
    intr8 = intrinsics / 8.0
    N = images.shape[0]
    cdt = compute_dtype
    net, inp, pyramid, coords0, coords1 = droidnet.prepare(
        params, images, Gs0, disps0, intr8, ii, jj, cdt)

    dP = se3.mul(Ps[jj], se3.inv(Ps[ii]))
    ii_adj, jj_adj = losses.adjacent_pairs(N, Ps.device)
    f_coords0, f_val0 = losses.flow_gt(Ps, disps_gt, intrinsics, ii_adj,
                                       jj_adj)

    def body(net, Gs, disps, coords1, target):
        net, Gs, disps, coords1, target, resid, upmask = droidnet.iteration(
            params, net, inp, pyramid, coords0, Gs, disps, coords1, target,
            intr8, ii, jj, 2, cdt)
        disp_up = nets.upsample_disp(disps, upmask)
        geo = losses.geodesic_step(dP, Gs, ii, jj, do_scale=False)
        flo, _, _ = losses.flow_step(f_coords0, f_val0, Gs, disp_up,
                                     intrinsics, ii_adj, jj_adj)
        return (net, Gs, disps, coords1, target, disp_up, geo,
                resid.abs().mean(), flo)

    Gs, disps, target = Gs0, disps0, coords1
    geo = res = flo = 0.0
    for i in range(num_steps):
        w = gamma ** (num_steps - 1 - i)
        net, Gs, disps, coords1, target, disp_up, g_i, r_i, f_i = checkpoint(
            body, net, Gs.detach(), disps.detach(), coords1.detach(),
            target.detach(), use_reentrant=False)
        geo = geo + w * g_i
        res = res + w * r_i
        flo = flo + w * f_i
    loss = cfg.w1 * geo + cfg.w2 * res + cfg.w3 * flo

    Gs_f, disp_up_f = Gs.detach(), disp_up.detach()
    with torch.no_grad():
        _, epe_f, v_f = losses.flow_step(f_coords0, f_val0, Gs_f, disp_up_f,
                                         intrinsics, ii_adj, jj_adj)
        metrics = {**losses.geodesic_metrics(dP, Gs_f, ii, jj,
                                             do_scale=False),
                   "residual": res.detach(),
                   **losses.flow_metrics(epe_f, v_f),
                   "loss": loss.detach()}
    return loss, (metrics, (Gs_f, disp_up_f[:, 3::8, 3::8]))


def batch_loss_backward(params, batch, Gs0, disps0, cfg, num_steps,
                        compute_dtype=torch.bfloat16):
    """Every sample's loss and backward (scaled by 1/B, so the gradients
    that accumulate in ``.grad`` are the batch mean); returns (the batch
    mean of each metric, the finals stacked)."""
    B = batch["images"].shape[0]
    sums = dict.fromkeys(METRIC_KEYS, 0.0)
    finals = []
    for b in range(B):
        loss, (m, fin) = sample_loss(
            params, batch["images"][b], batch["poses"][b], batch["disps"][b],
            batch["intrinsics"][b], Gs0[b], disps0[b], batch["ii"],
            batch["jj"], cfg, num_steps, compute_dtype=compute_dtype)
        (loss / B).backward()
        for k in METRIC_KEYS:
            sums[k] = sums[k] + m[k].float()
        finals.append(fin)
    metrics = {k: v / B for k, v in sums.items()}
    return metrics, (torch.stack([g for g, _ in finals]),
                     torch.stack([d for _, d in finals]))


def train_step(params, opt: Optimizer, batch, step: int, cfg: TrainConfig,
               num_steps=None, compute_dtype=torch.bfloat16, dp=None):
    """One optimizer step on ``batch`` (tensors on the params' device:
    images [B,N,H,W,3] uint8, poses [B,N,7] world-to-camera, disps
    [B,N,H,W], intrinsics [B,N,4], ii/jj [E]). The unroll runs once, then
    again from its detached finals while a draw from a generator seeded by
    ``step`` (the same on every rank) falls under ``cfg.restart_prob``, at
    most MAX_RESTARTS runs in all. With ``dp`` (a
    ``parallel.mesh.DataParallel``) ``batch`` is this rank's block, and the
    gradients and then the metrics are averaged over the ranks before the
    update; ``grad_nanfrac`` reads the averaged gradients. Returns the
    metrics of the last run as floats, with ``grad_nanfrac`` and
    ``restarts`` (runs after the first)."""
    num_steps = num_steps or cfg.iters
    gen = torch.Generator().manual_seed(int(step))
    inits = [default_init(P, d) for P, d in zip(batch["poses"],
                                                batch["disps"])]
    Gs0 = torch.stack([g for g, _ in inits])
    disps0 = torch.stack([d for _, d in inits])
    for p in params.values():
        p.grad = None
    runs = 0
    with f32_matmuls():
        while True:
            metrics, (Gs0, disps0) = batch_loss_backward(
                params, batch, Gs0, disps0, cfg, num_steps, compute_dtype)
            runs += 1
            r = float(torch.rand((), generator=gen))
            if not (r < cfg.restart_prob and runs < MAX_RESTARTS):
                break
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        if dp is not None:
            grads = dict(zip(grads, pmesh.all_reduce_mean(grads.values(),
                                                          dp)))
            metrics = dict(zip(metrics, pmesh.all_reduce_mean(
                metrics.values(), dp)))
        nanfrac = opt.step(grads)
    out = {k: float(v) for k, v in metrics.items()}
    out["grad_nanfrac"] = nanfrac
    out["restarts"] = runs - 1
    return out


def init_train_state(cfg: TrainConfig, seed: int = 0, params=None,
                     device="cuda"):
    """(params as leaf tensors that require grad on ``device``, the
    optimizer); the seeded random initialization when ``params`` is
    None."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_train_state: CUDA is not available; pass "
                           "device='cpu' to train on the CPU")
    if params is None:
        params = weights_io.init_params(seed)
    params = {k: v.detach().to(device, torch.float32).clone()
              .requires_grad_(True) for k, v in params.items()}
    return params, make_optimizer(params, cfg)

