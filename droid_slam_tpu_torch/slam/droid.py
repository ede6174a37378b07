"""Droid: the user-facing tracker, for monocular, stereo and RGB-D input.

Counterpart of ``droid_slam_tpu/slam/droid.py`` (``Droid.__init__``,
``track``, ``flush``, ``terminate``) on the per-call path the JAX package
takes on the CPU: each arriving frame first resolves the previous frame's
keyframe and admission decisions, then runs the frontend update, then begins
this frame's admission test. ``terminate()`` runs the global BA passes and
the trajectory filler.
"""

from __future__ import annotations

import functools
import time

import torch

from ..config import DroidConfig
from ..lie import se3
from ..models import weights as weights_io
from ..state.video import DepthVideo
from .backend import DroidBackend
from .frontend import DroidFrontend
from .motion_filter import MotionFilter
from .trajectory_filler import PoseTrajectoryFiller


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
        self.video = DepthVideo(config.image_size, config.buffer, device,
                                stereo=config.stereo,
                                upsample=config.upsample)
        self.filterx = MotionFilter(self.params, self.video,
                                    thresh=config.filter_thresh)
        self.frontend = DroidFrontend(self.params, self.video, config)
        self.backend = DroidBackend(self.params, self.video, config)
        self.traj_filler = PoseTrajectoryFiller(
            self.params, self.video,
            fused_epilogue=config.gru_fused_epilogue)
        self.terminate_stats = None

    @torch.no_grad()
    @_f32_matmuls
    def track(self, tstamp, image, depth=None, intrinsics=None):
        """image: uint8 BGR [H,W,3], or with ``config.stereo`` a rectified
        stack [2,H,W,3], left view first; depth: None, or a depth map
        [H,W] f32 (RGB-D; values <= 0 mark pixels without depth);
        intrinsics [fx, fy, cx, cy] at full resolution."""
        self._resolve_prev()
        self.frontend()
        self.filterx.track_begin(tstamp, image, depth, intrinsics)

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

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    @_f32_matmuls
    def terminate(self, stream=None, backend_steps=(7, 12)):
        """Finish tracking, run one global-BA pass per entry of
        ``backend_steps`` and, given the stream of all frames (tstamp,
        image or stereo stack, intrinsics), fill in the poses of the frames
        that are not keyframes. Returns camera-to-world poses [T,7] as numpy
        (T: the stream's frames, or the keyframes without a stream).

        Wall times land in ``terminate_stats``: ``backend_s`` (per pass),
        ``backend_edges`` (per pass), ``filler_s`` and ``total_s``."""
        t_all = time.perf_counter()
        self.flush()
        del self.frontend

        stats = {"backend_s": [], "backend_edges": [], "filler_s": 0.0}
        for steps in backend_steps:
            tic = time.perf_counter()
            stats["backend_edges"].append(self.backend(steps))
            self._sync()
            stats["backend_s"].append(time.perf_counter() - tic)

        if stream is not None:
            tic = time.perf_counter()
            traj = torch.as_tensor(self.traj_filler(stream))
            self._sync()
            stats["filler_s"] = time.perf_counter() - tic
        else:
            traj = self.video.poses[:self.video.counter].cpu()
        out = se3.inv(se3.normalize(traj)).numpy()
        stats["total_s"] = time.perf_counter() - t_all
        self.terminate_stats = stats
        return out
