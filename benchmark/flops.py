"""Floating-point operations of DroidNet's parts, from their shapes: 2 per
multiply-add of every convolution and matrix product the port's networks
run (``droid_slam_tpu_torch/models/nets.py``), as
``torch.utils.flop_counter`` counts them. Elementwise work (activations,
gates, the lookup's bilinear blend) and the bundle adjustment are not
counted: a count of the networks' work, the numerator of ``mfu.*``."""

from __future__ import annotations

CORR = 4 * (2 * 3 + 1) ** 2  # 196 lookup channels


def conv(n, cin, cout, h, w, k, stride=1):
    """A k x k convolution with the symmetric (k-1)//2 padding on n inputs
    [cin, h, w]."""
    p = (k - 1) // 2
    ho, wo = (h + 2 * p - k) // stride + 1, (w + 2 * p - k) // stride + 1
    return 2 * n * cout * ho * wo * cin * k * k


def encoder(H, W, out):
    """One basic encoder on one [3, H, W] image -> [out, H/8, W/8]."""
    f = conv(1, 3, 32, H, W, 7, 2)
    h, w = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    f += 4 * conv(1, 32, 32, h, w, 3)
    for cin, cout in ((32, 64), (64, 128)):
        f += conv(1, cin, cout, h, w, 3, 2) + conv(1, cin, cout, h, w, 1, 2)
        h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        f += 3 * conv(1, cout, cout, h, w, 3)
    return f + conv(1, 128, out, h, w, 1)


def encoders(H, W):
    """The feature and the context encoders on one image."""
    return encoder(H, W, 128) + encoder(H, W, 256)


def context_pre(E, h, w):
    """The context's share of the GRU's zr and q convolutions, once per
    update call (``nets.gru_context_pre``)."""
    return conv(E, 128, 256, h, w, 3) + conv(E, 128, 128, h, w, 3)


def update(E, h, w, pre=False):
    """The update operator on E edges of h x w: the correlation and flow
    encoders, the global gates, the ConvGRU and the flow and weight heads.
    With ``pre`` the GRU's context share is not included
    (``context_pre``)."""
    f = conv(E, CORR, 128, h, w, 1) + conv(E, 128, 128, h, w, 3)
    f += conv(E, 4, 128, h, w, 7) + conv(E, 128, 64, h, w, 3)
    f += conv(E, 128, 128, h, w, 1) + 2 * E * 128 * 384
    cin = 128 + (192 if pre else 320)
    f += conv(E, cin, 256, h, w, 3) + conv(E, cin, 128, h, w, 3)
    return f + conv(E, 128, 256, h, w, 3) + conv(E, 256, 4, h, w, 3)


def agg(E, frames, h, w):
    """The graph aggregation over E edges into ``frames`` frames and its
    damping head."""
    return (conv(E, 128, 128, h, w, 3) + conv(frames, 128, 128, h, w, 3)
            + conv(frames, 128, 1, h, w, 3))


def volumes(E, h, w):
    """The correlation volumes of E new edges."""
    return 2 * E * (h * w) ** 2 * 128


def alt_corr(E, h, w, levels=4, radius=3):
    """The on-the-fly correlation of E edges: (2r+2)^2 dot products of 128
    channels per pixel and level."""
    return 2 * E * h * w * levels * (2 * radius + 2) ** 2 * 128
