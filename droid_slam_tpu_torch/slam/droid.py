"""Droid: the user-facing tracker, for monocular, stereo and RGB-D input.

Counterpart of ``droid_slam_tpu/slam/droid.py`` (``TrackPipeline``,
``Droid.__init__``, ``track``, ``flush``, ``terminate``) on the per-call
path the JAX package takes on the CPU: each arriving frame first resolves
the previous frame's keyframe and admission decisions, then runs the
frontend update, then begins this frame's admission test. ``terminate()``
runs the global BA passes and the trajectory filler. ``TrackPipeline`` is
the tracking half, which the asynchronous facades (``slam/async_droid.py``,
``slam/async_process.py``) share.
"""

from __future__ import annotations

import contextlib
import functools
import threading
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

_TF32_FLAGS = (torch.backends.cuda.matmul, torch.backends.cudnn)
_tf32_lock = threading.Lock()
_tf32_scopes = [0, None]  # open scopes in every thread, the saved flags


@contextlib.contextmanager
def f32_matmuls():
    """TF32 off for matmuls and cuDNN inside, the caller's settings back
    when the last scope open in any thread closes: the geometry and BA run
    in f32, as the JAX package's ``precision="highest"`` einsums do, also
    while the asynchronous backend's thread runs beside the tracker. The
    bf16 networks are unaffected."""
    with _tf32_lock:
        if _tf32_scopes[0] == 0:
            _tf32_scopes[1] = [f.allow_tf32 for f in _TF32_FLAGS]
            for f in _TF32_FLAGS:
                f.allow_tf32 = False
        _tf32_scopes[0] += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_scopes[0] -= 1
            if _tf32_scopes[0] == 0:
                for f, v in zip(_TF32_FLAGS, _tf32_scopes[1]):
                    f.allow_tf32 = v


def _f32_matmuls(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with f32_matmuls():
            return fn(*args, **kwargs)
    return wrapped


class TrackPipeline:
    """The tracking half of every facade: weights, the keyframe video, the
    motion filter and the frontend, and ``track`` / ``flush``."""

    def __init__(self, config: DroidConfig, device="cuda",
                 edge_devices=None):
        """device: where the video, the networks and the BA run.
        edge_devices: with ``config.edge_parallel`` = N, the N devices of
        the edge-parallel update (they may repeat); cuda:0..N-1 when
        None."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{type(self).__name__}: CUDA is not "
                               "available; pass device='cpu' to run on the "
                               "CPU")
        self.config = config
        self.device = device
        self.params = weights_io.load(config.weights, device)
        self.video = DepthVideo(config.image_size, config.buffer, device,
                                stereo=config.stereo,
                                upsample=config.upsample)
        self.filterx = MotionFilter(self.params, self.video,
                                    thresh=config.filter_thresh)
        self.frontend = DroidFrontend(self.params, self.video, config,
                                      edge_devices)

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


class Droid(TrackPipeline):
    def __init__(self, config: DroidConfig, device="cuda",
                 edge_devices=None):
        super().__init__(config, device, edge_devices)
        self.backend = DroidBackend(self.params, self.video, config)
        self.traj_filler = PoseTrajectoryFiller(
            self.params, self.video,
            fused_epilogue=config.gru_fused_epilogue)
        self.terminate_stats = None

        # the live viewer (eval/viewer.py), off unless asked for; terminate()
        # stops it
        self._vis_stop = self._vis_thread = None
        if config.enable_vis:
            from ..eval.viewer import launch_viewer
            self._vis_stop = threading.Event()
            self._vis_thread = threading.Thread(
                target=launch_viewer, args=(self.video, None, self._vis_stop),
                daemon=True)
            self._vis_thread.start()

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
        if self._vis_stop is not None:
            self._vis_stop.set()
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
