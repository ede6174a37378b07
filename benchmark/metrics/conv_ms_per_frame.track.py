"""Milliseconds of device time in convolution kernels (cuDNN's, by kernel
name: inside CUDA graph replays no launching operator is recorded) per
tracked frame: the encoders and the update operator."""

import re

LAYER = "update operator and encoders (models/nets.py)"
UNIT = "ms"
MOVES = "track_fps"
CONV = re.compile(r"conv|fprop|implicit_gemm|winograd|cudnn", re.I)


def read(ctx):
    tl = ctx["timeline"]
    if tl is None or not ctx["frames"]:
        return None
    t = sum(s for n, s in tl.time_by_name().items() if CONV.search(n))
    return 1e3 * t / ctx["frames"] if t > 0 else None
