"""Droid: the user-facing monocular tracker.

Counterpart of ``droid_slam_tpu/slam/droid.py`` (``Droid.__init__``,
``track``, ``flush``) on the per-call path the JAX package takes on the CPU:
each arriving frame first resolves the previous frame's keyframe and
admission decisions, then runs the frontend update, then begins this frame's
admission test. ``terminate()`` (global BA and the trajectory filler) is not
part of this slice.
"""

from __future__ import annotations

import functools

import torch

from ..config import DroidConfig
from ..models import weights as weights_io
from ..state.video import DepthVideo
from .frontend import DroidFrontend
from .motion_filter import MotionFilter


def _f32_matmuls(fn):
    """Run fn with TF32 off for matmuls and cuDNN, then restore the caller's
    settings: the geometry and BA run in f32, as the JAX package's
    ``precision="highest"`` einsums do. The bf16 networks are unaffected."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        flags = torch.backends.cuda.matmul, torch.backends.cudnn
        saved = [f.allow_tf32 for f in flags]
        try:
            for f in flags:
                f.allow_tf32 = False
            return fn(*args, **kwargs)
        finally:
            for f, v in zip(flags, saved):
                f.allow_tf32 = v
    return wrapped


class Droid:
    def __init__(self, config: DroidConfig, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Droid: CUDA is not available; pass "
                               "device='cpu' to run on the CPU")
        self.config = config
        self.device = device
        self.params = weights_io.load(config.weights, device)
        self.video = DepthVideo(config.image_size, config.buffer, device)
        self.filterx = MotionFilter(self.params, self.video,
                                    thresh=config.filter_thresh)
        self.frontend = DroidFrontend(self.params, self.video, config)

    @torch.no_grad()
    @_f32_matmuls
    def track(self, tstamp, image, intrinsics):
        """image: uint8 BGR [H,W,3]; intrinsics [fx, fy, cx, cy] at full
        resolution."""
        self._resolve_prev()
        self.frontend()
        self.filterx.track_begin(tstamp, image, intrinsics)

    def _resolve_prev(self):
        self.frontend.finalize()
        self.filterx.track_finish()

    @torch.no_grad()
    @_f32_matmuls
    def flush(self):
        """Resolve the last frame's admission and run its update."""
        self._resolve_prev()
        self.frontend()
        self.frontend.finalize()
