"""Functional NN building blocks on NCHW tensors and a flat parameter dict.

Counterpart of ``droid_slam_tpu/models/layers.py``. Parameters are a flat
``dict[str, Tensor]`` keyed by the reference's ``state_dict`` names, with
conv weights in PyTorch's OIHW layout (models/weights.py converts from the
JAX package's HWIO). Convolutions run in the input's dtype; the bias is
added after the convolution in that dtype, as the JAX package does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(params: dict, name: str, x: torch.Tensor, stride: int = 1,
           padding=None) -> torch.Tensor:
    """Convolution with ``<name>.weight`` [out,in,kh,kw] and optional
    ``<name>.bias``. Padding defaults to the symmetric (k-1)//2 of the
    reference's torch modules, which is also what the JAX package pads
    explicitly (not XLA's asymmetric "SAME")."""
    w = params[name + ".weight"]
    return conv_nobias(x, w, stride=stride, padding=padding,
                       bias=params.get(name + ".bias"))


def conv_nobias(x, w, stride: int = 1, padding=None, bias=None):
    w = w.to(x.dtype)
    if padding is None:
        padding = ((w.shape[2] - 1) // 2, (w.shape[3] - 1) // 2)
    y = F.conv2d(x, w, stride=stride, padding=padding)
    if bias is not None:
        y = y + bias.to(y.dtype)[None, :, None, None]
    return y


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample per-channel normalization over H,W, computed in f32."""
    x32 = x.float()
    mean = x32.mean(dim=(2, 3), keepdim=True)
    var = x32.var(dim=(2, 3), unbiased=False, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class _GradientClip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
        return torch.where(g.abs() > 0.01, torch.zeros_like(g), g)


def gradient_clip(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; the backward zeroes gradient entries that are NaN
    or larger than 0.01 in magnitude (droid_slam_tpu/models/layers.py:
    54-71). Outside autograd it returns x itself."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GradientClip.apply(x)
    return x
