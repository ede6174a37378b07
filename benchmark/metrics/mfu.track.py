"""The whole frame's share of the card's bf16 peak: the networks' FLOPs
(``benchmark/flops.py``) of every tracked frame over the window's seconds
and the published dense bf16 rate. A frame encodes its image (both
encoders) and runs the admission update on one edge; a frame with an
update adds the GRU's context share once and, per iteration that was kept
(3, and 2 more when the keyframe stays), the update operator and the
aggregation over the live edges, and the volumes of its new edges."""

from benchmark import flops, peaks

LAYER = "whole step (DroidNet)"
UNIT = "%"
MOVES = "track_fps"


def read(ctx):
    peak = peaks.get(ctx["device"]["kind"], "bf16_dense_flops_per_s")
    if peak is None or not ctx["frames"]:
        return None
    H, W = ctx["image_size"]
    h, w = H // 8, W // 8
    total = ctx["frames"] * (flops.encoders(H, W) + flops.update(1, h, w))
    for c in ctx["updates"]:
        n = c["iters1"] + (c["iters2"] if c["keep"] else 0)
        E = c["edges"]
        total += flops.context_pre(E, h, w) + flops.volumes(c["new"], h, w)
        total += n * (flops.update(E, h, w, pre=True)
                      + flops.agg(E, c["frames"], h, w))
    return 100.0 * total / (ctx["window_s"] * peak)
