"""DroidNet in plain PyTorch: the feature and context encoders, the update
operator (correlation and flow encoders, the ConvGRU with global context
gates, the flow and weight heads) and the graph aggregation's damping
head, as DROID-SLAM's ``droid_net.py`` defines them, on the ``.npz`` of
the JAX package (HWIO convolutions, the reference's ``state_dict`` names).

Every convolution runs in float32, or in the control precision: its input
and its weights rounded to float8 (e4m3, one scale per tensor, as an fp8
inference path would hold them) and accumulated in float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)
FP8_MAX = 448.0


def load_params(path, device):
    """{state_dict name: f32 tensor}, convolutions made OIHW."""
    out = {}
    with np.load(path) as z:
        for k in z.files:
            a = np.asarray(z[k], np.float32)
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def fp8(x):
    """x rounded to float8 e4m3 with one scale for the tensor."""
    s = x.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def conv(p, name, x, low, stride=1):
    w = p[name + ".weight"]
    if low:
        x, w = fp8(x), fp8(w)
    pad = ((w.shape[2] - 1) // 2, (w.shape[3] - 1) // 2)
    return F.conv2d(x, w, p.get(name + ".bias"), stride=stride, padding=pad)


def _inorm(x):
    m = x.mean(dim=(2, 3), keepdim=True)
    v = x.var(dim=(2, 3), unbiased=False, keepdim=True)
    return (x - m) * torch.rsqrt(v + 1e-5)


def _encoder(p, pre, x, norm, low):
    nf = _inorm if norm else (lambda y: y)
    x = F.relu(nf(conv(p, pre + ".conv1", x, low, stride=2)))
    for layer, stride in (("layer1", 1), ("layer2", 2), ("layer3", 2)):
        for blk in range(2):
            s = stride if blk == 0 else 1
            b = f"{pre}.{layer}.{blk}"
            y = F.relu(nf(conv(p, b + ".conv1", x, low, stride=s)))
            y = F.relu(nf(conv(p, b + ".conv2", y, low)))
            if s != 1:
                x = nf(conv(p, b + ".downsample.0", x, low, stride=s))
            x = F.relu(x + y)
    return conv(p, pre + ".conv2", x, low)


def encode(p, images, low=False):
    """uint8 BGR images [N,H,W,3] -> fmap [N,128,h,w], net = tanh, inp =
    relu of the context encoder's halves [N,128,h,w]; float32."""
    x = images.flip(-1).float() / 255.0
    mean = torch.tensor(_MEAN, device=x.device)
    std = torch.tensor(_STD, device=x.device)
    x = ((x - mean) / std).permute(0, 3, 1, 2).contiguous()
    fmap = _encoder(p, "fnet", x, True, low)
    net, inp = _encoder(p, "cnet", x, False, low).split(128, dim=1)
    return fmap, torch.tanh(net), F.relu(inp)


def update(p, net, inp, corr, flow, low=False):
    """One step of the update operator on E edges: net, inp [E,128,h,w],
    corr [E,196,h,w], flow [E,4,h,w] -> (net, delta [E,2,h,w],
    weight [E,2,h,w])."""
    c = F.relu(conv(p, "update.corr_encoder.0", corr, low))
    c = F.relu(conv(p, "update.corr_encoder.2", c, low))
    f = F.relu(conv(p, "update.flow_encoder.0", flow, low))
    f = F.relu(conv(p, "update.flow_encoder.2", f, low))
    x = torch.cat([inp, c, f], dim=1)

    glo = torch.sigmoid(conv(p, "update.gru.w", net, low)) * net
    glo = glo.mean(dim=(2, 3), keepdim=True)
    gz, gr, gq = (conv(p, f"update.gru.conv{k}_glo", glo, low)
                  for k in "zrq")
    hx = torch.cat([net, x], dim=1)
    z = torch.sigmoid(conv(p, "update.gru.convz", hx, low) + gz)
    r = torch.sigmoid(conv(p, "update.gru.convr", hx, low) + gr)
    q = torch.tanh(conv(p, "update.gru.convq", torch.cat([r * net, x], 1),
                        low) + gq)
    net = (1 - z) * net + z * q
    delta = conv(p, "update.delta.2",
                 F.relu(conv(p, "update.delta.0", net, low)), low)
    weight = torch.sigmoid(conv(p, "update.weight.2",
                                F.relu(conv(p, "update.weight.0", net, low)),
                                low))
    return net, delta, weight


def damping(p, net, ii, n, low=False):
    """The graph aggregation's damping: the mean over each source frame's
    edges (ii [E] in [0, n)), then the eta head -> [n,h,w]; frames without
    edges get the head of zeros."""
    x = F.relu(conv(p, "update.agg.conv1", net, low))
    cnt = x.new_zeros(n).index_add_(0, ii, x.new_ones(len(ii)))
    s = x.new_zeros((n,) + x.shape[1:]).index_add_(0, ii, x)
    y = F.relu(conv(p, "update.agg.conv2",
                    s / cnt.clamp(min=1.0)[:, None, None, None], low))
    return 0.01 * F.softplus(conv(p, "update.agg.eta.0", y, low))[:, 0]
