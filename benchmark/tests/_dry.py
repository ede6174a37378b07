"""Small runs of the benchmark's cells on the CPU, for the tests: the port's
plain path (the frame programs run eagerly), images of 128x192 (tracking;
at 64x96 a frame's disparities move too little for the limits) or 64x96
(global BA), a short stream and window. The tracking cells admit at a
lower threshold, so that a few seconds of frames hold updates at this
size, and warm up on 6 frames. The runs take the cells' limits, but for
one set from readings at this size."""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL = {
    "euroc_mono.track": {"config": {"image_size": [128, 192],
                                    "buffer": 300, "fused_frame": True,
                                    "filter_thresh": 1.2},
                         # at this size the poses' gaps read ten times the
                         # cell's (program 0.0038, control 0.079)
                         "limits": {"update_pose_gap": 0.02}},
    "euroc_mono.track_slow": {"config": {"image_size": [128, 192],
                                         "buffer": 300, "fused_frame": True,
                                         "filter_thresh": 0.5}},
    "tum_mono.global_ba": {"config": {"image_size": [64, 96], "buffer": 40},
                           "traffic": {"keyframes": 32}},
}
SECONDS = {"euroc_mono.track": 10.0, "euroc_mono.track_slow": 10.0,
           "tum_mono.global_ba": 3.0}


def dry_run(workload, trace=0, seed=123456789012, control=False,
            overrides=None, seconds=None):
    """The result record of a small CPU run of ``workload``."""
    import copy

    import torch
    torch.set_num_threads(min(4, torch.get_num_threads()))
    from benchmark import run
    from benchmark.loops import track
    ov = copy.deepcopy(SMALL[workload])
    for part, vals in (overrides or {}).items():
        ov.setdefault(part, {}).update(vals)
    warm = track.WARMUP_FRAMES
    track.WARMUP_FRAMES = 6
    try:
        return run.run_cell(workload, seed, seconds or SECONDS[workload],
                            trace, device="cpu", overrides=ov,
                            control=control, t_start=time.perf_counter())
    finally:
        track.WARMUP_FRAMES = warm
