"""The whole global-BA step's share of the card's bf16 peak: per step, the
update operator over every edge of its pass (with the 320-channel context
path), the aggregation over the pass's keyframes and the on-the-fly
correlation (``benchmark/flops.py``), over the window's seconds and the
published dense bf16 rate."""

from benchmark import flops, peaks

LAYER = "whole step (DroidNet)"
UNIT = "%"
MOVES = "gba_s_per_step"


def read(ctx):
    peak = peaks.get(ctx["device"]["kind"], "bf16_dense_flops_per_s")
    if peak is None:
        return None
    H, W = ctx["image_size"]
    h, w = H // 8, W // 8
    t = ctx["keyframes"]
    total = sum(ctx["steps_per_pass"] * (flops.update(E, h, w)
                                         + flops.agg(E, t, h, w)
                                         + flops.alt_corr(E, h, w))
                for E in ctx["edges"])
    return 100.0 * total / (ctx["window_s"] * peak)
