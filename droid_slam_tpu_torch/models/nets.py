"""DROID networks: feature/context encoders, the ConvGRU update operator and
graph aggregation, as plain functions on NCHW tensors.

Counterpart of ``droid_slam_tpu/models/nets.py``: the GRU's context
contributions are precomputed once per update call (``gru_context_pre``) and
the zr and q convolutions take ``[net | corr,flow features]`` in one conv
each. With ``fused_epilogue`` (the JAX package's ``DROID_GRU_PALLAS=1``) the
GRU instead runs its gate arithmetic in the two fused epilogues of
``ops/gru_cuda.py``. ``graph_agg`` also runs the upsampling-mask head on
request, and ``upsample_disp`` turns a mask into full-resolution
disparities (convex upsampling). Under autograd (training) the flow and
weight head and the damping head pass through ``gradient_clip``, as in the
JAX package.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops import gru_cuda
from .layers import conv2d, conv_nobias, gradient_clip, instance_norm

DIM = 32
CORR_PLANES = 4 * (2 * 3 + 1) ** 2  # 196

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def _resblock(params, prefix, x, norm: bool, stride: int):
    def norm_fn(h):
        return instance_norm(h) if norm else h

    y = F.relu(norm_fn(conv2d(params, prefix + ".conv1", x, stride=stride)))
    y = F.relu(norm_fn(conv2d(params, prefix + ".conv2", y)))
    if stride != 1:
        x = norm_fn(conv2d(params, prefix + ".downsample.0", x, stride=stride))
    return F.relu(x + y)


def basic_encoder(params, prefix, x, norm: bool):
    """x [N,3,H,W] -> [N,out,H/8,W/8]."""
    x = conv2d(params, prefix + ".conv1", x, stride=2)
    x = F.relu(instance_norm(x) if norm else x)
    for layer, stride in (("layer1", 1), ("layer2", 2), ("layer3", 2)):
        for blk in range(2):
            x = _resblock(params, f"{prefix}.{layer}.{blk}", x, norm,
                          stride if blk == 0 else 1)
    return conv2d(params, prefix + ".conv2", x)


@functools.lru_cache(maxsize=None)
def _mean_std(device):
    """The normalization constants, made once per device: a copy from the
    host per call could not be captured in a CUDA graph."""
    return (torch.tensor(_MEAN, device=device),
            torch.tensor(_STD, device=device))


def normalize_images(images_bgr_u8: torch.Tensor) -> torch.Tensor:
    """uint8 BGR [N,H,W,3] -> normalized RGB f32 [N,3,H,W]."""
    x = images_bgr_u8.flip(-1).float() / 255.0
    mean, std = _mean_std(x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2).contiguous()


def extract_features(params, images_bgr_u8, compute_dtype=torch.float32,
                     cnet_views=None):
    """fnet + cnet: (fmap [N,128,h,w], tanh(net), relu(inp)). cnet runs on
    the first ``cnet_views`` images only (all when None): a stereo frame
    takes its context from the left view."""
    x = normalize_images(images_bgr_u8).to(compute_dtype)
    fmap = basic_encoder(params, "fnet", x, norm=True)
    net, inp = basic_encoder(params, "cnet", x[:cnet_views],
                             norm=False).split(128, dim=1)
    return fmap, torch.tanh(net), F.relu(inp)


# ---------------------------------------------------------------------------
# ConvGRU with global context gates
# ---------------------------------------------------------------------------

_GLO = ["update.gru.convz_glo", "update.gru.convr_glo",
        "update.gru.convq_glo"]
_ZR = ["update.gru.convz", "update.gru.convr"]
_HEAD0 = ["update.delta.0", "update.weight.0"]


def _merged(params, names):
    w = torch.cat([params[n + ".weight"] for n in names], dim=0)
    b = torch.cat([params[n + ".bias"] for n in names], dim=0)
    return w, b


def _head_block(params):
    """The flow and weight heads' 2-channel second convs as one
    block-diagonal 256->4 conv: (weight, bias)."""
    d2 = params["update.delta.2.weight"]
    w2 = params["update.weight.2.weight"]
    blk = d2.new_zeros((4, 256) + tuple(d2.shape[2:]))
    blk[:2, :128] = d2
    blk[2:, 128:] = w2
    return blk, torch.cat([params["update.delta.2.bias"],
                           params["update.weight.2.bias"]])


class Merged(NamedTuple):
    """``update_module``'s merged weights (``merge_update``): each a
    (weight, bias) pair."""
    glo: tuple    # the three global-context gates
    zr: tuple     # convz and convr
    head0: tuple  # delta.0 and weight.0
    head2: tuple  # delta.2 and weight.2, block-diagonal


def merge_update(params):
    """The merges ``update_module`` makes on every call, unless a caller
    that runs it many times with the same weights (the global BA's sweep)
    makes them once and passes them as its ``merged``."""
    return Merged(_merged(params, _GLO), _merged(params, _ZR),
                  _merged(params, _HEAD0), _head_block(params))


def _glo_gates(params, net, gates):
    """Global-context gate biases gz, gr, gq, each [E,128,1,1]; ``gates``:
    their merged (weight, bias)."""
    glo = torch.sigmoid(conv2d(params, "update.gru.w", net)) * net
    glo = glo.float().mean(dim=(2, 3)).to(net.dtype)
    w, b = gates
    zrq = glo @ w.reshape(w.shape[0], w.shape[1]).t().to(glo.dtype) \
        + b.to(glo.dtype)
    return zrq[:, :, None, None].split(128, dim=1)


def gru_context_pre(params, inp):
    """Contributions of the context features to the zr and q convolutions:
    fixed across the iterations of one update call, so computed once."""
    wzr, _ = _merged(params, _ZR)
    wq = params["update.gru.convq.weight"]
    return (conv_nobias(inp, wzr[:, 128:256]),
            conv_nobias(inp, wq[:, 128:256]))


def conv_gru(params, net, inp, merged, pre=None, fused_epilogue=False):
    """net [E,128,h,w]. Without ``pre``, inp is [context | corr | flow]
    features [E,320,h,w]; with ``pre`` (gru_context_pre of the context),
    inp is the [corr | flow] features [E,192,h,w]. Returns the new net.

    ``fused_epilogue`` (taken only with ``pre``): the gate sums and
    activations run in the two fused epilogue kernels between three
    convolutions, as ``droid_slam_tpu/models/nets.py:195-210`` does.
    ``merged``: ``merge_update(params)``."""
    gz, gr, gq = _glo_gates(params, net, merged.glo)
    wzr, bzr = merged.zr
    wq = params["update.gru.convq.weight"]
    bq = params["update.gru.convq.bias"]

    if pre is None:
        zr = conv_nobias(torch.cat([net, inp], dim=1), wzr) \
            + bzr.to(net.dtype)[:, None, None]
        z = torch.sigmoid(zr[:, :128] + gz)
        r = torch.sigmoid(zr[:, 128:] + gr)
        q = torch.tanh(conv2d(params, "update.gru.convq",
                              torch.cat([r * net, inp], dim=1)) + gq)
        return (1.0 - z) * net + z * q

    pre_zr, pre_q = pre
    if fused_epilogue:
        # the zr and q convs share the corr/flow features: one merged
        # 192->384 conv (on NCHW features, so that its output is the
        # contiguous NCHW the kernels read; the features arrive channels-last
        # from the lookup's transposed output); the gate biases are
        # pre-summed in the working dtype, where JAX rounds them
        cf = conv_nobias(inp.contiguous(),
                         torch.cat([wzr[:, 256:], wq[:, 256:]]))
        gzr = torch.cat([gz, gr], dim=1)[:, :, 0, 0] + bzr.to(net.dtype)
        gqb = gq[:, :, 0, 0] + bq.to(net.dtype)
        zrc = conv_nobias(net, wzr[:, :128])
        z, rnet = gru_cuda.gru_epilogue_a(zrc, cf, pre_zr, net, gzr)
        qc = conv_nobias(rnet, wq[:, :128])
        return gru_cuda.gru_epilogue_b(qc, cf, pre_q, net, z, gqb)

    x = torch.cat([net, inp], dim=1)
    wzr_x = torch.cat([wzr[:, :128], wzr[:, 256:]], dim=1)
    zr = conv_nobias(x, wzr_x) + pre_zr + bzr.to(net.dtype)[:, None, None]
    z = torch.sigmoid(zr[:, :128] + gz)
    r = torch.sigmoid(zr[:, 128:] + gr)
    wq_x = torch.cat([wq[:, :128], wq[:, 256:]], dim=1)
    q = torch.tanh(conv_nobias(torch.cat([r * net, inp], dim=1), wq_x)
                   + pre_q + bq.to(net.dtype)[:, None, None] + gq)
    return (1.0 - z) * net + z * q


# ---------------------------------------------------------------------------
# update operator + graph aggregation
# ---------------------------------------------------------------------------

def update_module(params, net, inp, corr, flow=None, ii=None,
                  num_frames=None, pre=None, fused_epilogue=False,
                  compute_upmask=False, merged=None):
    """Update operator on a batch of edges (``fused_epilogue``: see
    ``conv_gru``; it applies only with ``pre``; ``merged``:
    ``merge_update(params)``, made here when not given).

    net/inp [E,128,h,w], corr [E,196,h,w], flow [E,4,h,w] (zeros if None).
    Returns (net, delta [E,2,h,w], weight [E,2,h,w]), plus, when ``ii``
    (source frame of each edge, in [0, num_frames)) is given, the per-frame
    damping eta [num_frames,h,w] and upsampling mask (``graph_agg``).
    """
    E, _, h, w = net.shape
    if merged is None:
        merged = merge_update(params)
    if flow is None:
        flow = torch.zeros((E, 4, h, w), dtype=net.dtype, device=net.device)
    c = F.relu(conv2d(params, "update.corr_encoder.0", corr))
    c = F.relu(conv2d(params, "update.corr_encoder.2", c))
    f = F.relu(conv2d(params, "update.flow_encoder.0", flow))
    f = F.relu(conv2d(params, "update.flow_encoder.2", f))

    if pre is None:
        net = conv_gru(params, net, torch.cat([inp, c, f], dim=1), merged)
    else:
        net = conv_gru(params, net, torch.cat([c, f], dim=1), merged,
                       pre=pre, fused_epilogue=fused_epilogue)

    # delta.0 and weight.0 share their input: one 128->256 conv; their
    # 2-channel second convs become one block-diagonal 256->4 conv
    wd0, bd0 = merged.head0
    ds = F.relu(conv_nobias(net, wd0) + bd0.to(net.dtype)[:, None, None])
    blk, bias4 = merged.head2
    head = gradient_clip(conv_nobias(ds, blk)
                         + bias4.to(net.dtype)[:, None, None])
    delta = head[:, :2]
    weight = torch.sigmoid(head[:, 2:])
    if ii is None:
        return net, delta, weight
    eta, upmask = graph_agg(params, net, ii, num_frames,
                            compute_upmask=compute_upmask)
    return net, delta, weight, eta, upmask


def graph_agg(params, net, ii, num_frames, compute_upmask=False):
    """Mean over the edges of each source frame, then the damping head and,
    with ``compute_upmask``, the upsampling-mask head: (eta [num_frames,h,w],
    upmask [num_frames,576,h,w] in the network's dtype, or None). Frames
    without edges get the heads of zeros."""
    counts, sums = graph_agg_sums(params, net, ii, num_frames)
    return graph_agg_heads(params, counts, sums, compute_upmask)


def graph_agg_sums(params, net, ii, num_frames):
    """graph_agg's per-frame edge counts [num_frames] and feature sums
    [num_frames,128,h,w] over these edges: with the edges sharded, each
    shard's are summed across shards before ``graph_agg_heads`` (JAX's
    ``psum_axis``, droid_slam_tpu/models/nets.py:333-349)."""
    x = F.relu(conv2d(params, "update.agg.conv1", net))
    counts = x.new_zeros(num_frames).index_add_(0, ii, x.new_ones(x.shape[0]))
    sums = x.new_zeros((num_frames,) + x.shape[1:]).index_add_(0, ii, x)
    return counts, sums


def graph_agg_heads(params, counts, sums, compute_upmask=False):
    """graph_agg's mean and heads from the (summed) counts and sums."""
    mean = sums / counts.clamp(min=1.0)[:, None, None, None]
    y = F.relu(conv2d(params, "update.agg.conv2", mean))
    eta = F.softplus(gradient_clip(conv2d(params, "update.agg.eta.0", y)))
    upmask = (conv2d(params, "update.agg.upmask.0", y) if compute_upmask
              else None)
    return 0.01 * eta[:, 0], upmask


# ---------------------------------------------------------------------------
# convex upsampling (droid_slam_tpu/models/nets.py:359-385)
# ---------------------------------------------------------------------------

def cvx_upsample(data, mask):
    """data [N,dim,h,w], mask [N,576,h,w] -> [N,dim,8h,8w] in f32.

    Each full-resolution pixel is a convex combination of the 3x3
    neighbourhood of its feature pixel: the mask's channels are laid out
    [9, 8, 8] (neighbour, y-subpixel, x-subpixel), neighbours row-major, and
    softmax-normalised over the 9. The combination is written as products
    and a sum over the 9 neighbours in f32 (no matmul, so TF32 cannot
    enter), as the JAX package's ``precision="highest"`` einsum computes
    it."""
    N, dim, h, w = data.shape
    mask = torch.softmax(mask.float().reshape(N, 1, 9, 8, 8, h, w), dim=2)
    patches = F.unfold(data.float(), (3, 3), padding=1)
    patches = patches.reshape(N, dim, 9, 1, 1, h, w)
    up = (mask * patches).sum(2)                     # [N,dim,8(y),8(x),h,w]
    return up.permute(0, 1, 4, 2, 5, 3).reshape(N, dim, 8 * h, 8 * w)


def upsample_disp(disp, mask):
    """disp [N,h,w], mask [N,576,h,w] -> [N,8h,8w] f32."""
    return cvx_upsample(disp[:, None], mask)[:, 0]
