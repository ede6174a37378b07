"""Block timers: wall-clock milliseconds with the device synchronised at the
block's end, and a ``torch.profiler`` trace of a block.

Counterpart of ``droid_slam_tpu/utils/timer.py``; ``torch.cuda.synchronize``
takes the place of ``block_until_ready``.
"""

from __future__ import annotations

import contextlib
import time

import torch


def _synchronize(sync):
    """Wait for the CUDA devices of ``sync``: a tensor, a device (or its
    name), or a list or tuple of these. CPU work is already done."""
    if isinstance(sync, (list, tuple)):
        for s in sync:
            _synchronize(s)
        return
    dev = sync.device if isinstance(sync, torch.Tensor) else torch.device(sync)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Timer:
    """``with Timer("frontend", sync=tensor): ...`` prints the block's
    elapsed ms, after waiting for ``sync``'s device (see ``_synchronize``)."""

    def __init__(self, name: str, enabled: bool = True, sync=None):
        self.name = name
        self.enabled = enabled
        self.sync = sync

    def __enter__(self):
        if self.enabled:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            if self.sync is not None:
                _synchronize(self.sync)
            dt = 1000.0 * (time.perf_counter() - self.t0)
            print(f"{self.name}: {dt:.2f} ms")


@contextlib.contextmanager
def profile_trace(logdir: str):
    """A ``torch.profiler`` trace of the block (the host's ops, and the
    card's kernels when CUDA is available), written to ``logdir`` as a
    Chrome/TensorBoard trace file."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
