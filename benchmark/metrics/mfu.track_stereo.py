"""The whole stereo frame's share of the card's bf16 peak: ``mfu.track``'s
count (``benchmark/flops.py``) over the window's seconds and the published
dense bf16 rate, with a stereo frame's encoders: the feature encoder on
both views, the context encoder on the left view. A frame also runs the
admission update on one edge; a frame with an update adds what
``mfu.track`` counts per update, whose volumes of the new edges include
the stereo edges' (each against the right view, at a monocular edge's
cost)."""

from benchmark import flops, peaks

LAYER = "whole step (DroidNet, stereo)"
UNIT = "%"
MOVES = "track_fps"


def encoders(H, W):
    """The encoders on one rectified pair: fnet on both views, cnet on the
    left one (``models/nets.py::extract_features`` with ``cnet_views``
    1)."""
    return 2 * flops.encoder(H, W, 128) + flops.encoder(H, W, 256)


def read(ctx):
    peak = peaks.get(ctx["device"]["kind"], "bf16_dense_flops_per_s")
    if peak is None or not ctx["frames"]:
        return None
    H, W = ctx["image_size"]
    h, w = H // 8, W // 8
    total = ctx["frames"] * (encoders(H, W) + flops.update(1, h, w))
    for c in ctx["updates"]:
        n = c["iters1"] + (c["iters2"] if c["keep"] else 0)
        E = c["edges"]
        total += flops.context_pre(E, h, w) + flops.volumes(c["new"], h, w)
        total += n * (flops.update(E, h, w, pre=True)
                      + flops.agg(E, c["frames"], h, w))
    return 100.0 * total / (ctx["window_s"] * peak)
