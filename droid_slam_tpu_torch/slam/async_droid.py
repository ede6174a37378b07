"""DroidAsync: tracking with the global BA running beside it, in a thread.

Counterpart of ``droid_slam_tpu/slam/async_droid.py``. The backend owns a
second keyframe video (``video2``) and a persistent factor graph
(``DroidAsyncBackend``). Once the tracker holds more than 32 keyframes,
every ``sleep_time`` seconds the backend thread copies the tracker's
keyframes [t0, t1) under the tracker video's lock (t0 = the backend's count
less 2, t1 = the tracker's count less 5), brings them into its own frame
(``merge_frames``: a scale for monocular input without sensor depth and an
SE3 mean over the 10 keyframes before t0) and runs ``backend_iters`` global-
BA steps. ``terminate()`` sets ``video2.ready``: the thread runs a last cycle
up to the tracker's count and stops; then the trajectory filler runs on the
backend's video.

On a machine with a second card the backend (``video2``, its graph and the
trajectory filler) runs there (``backend_device``; JAX puts them on
``devs[1]``, droid_slam_tpu/slam/async_droid.py:47-52), and the snapshot's
copies move to it. Otherwise it shares the tracker's device and, on CUDA,
issues its work on a stream of its own, so that its kernels can fill the
tracker's idle gaps. The tracker writes on its device's default stream: the
snapshot waits for the writes already issued there, and that stream waits
for the snapshot's copies before the tracker's later work, which may
overwrite or free what they read.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

from ..config import DroidConfig
from ..lie import se3
from ..state.video import DepthVideo
from .align import align_pose_fragments
from .backend import DroidAsyncBackend
from .droid import TrackPipeline, _f32_matmuls, f32_matmuls
from .trajectory_filler import PoseTrajectoryFiller

START_KEYFRAMES = 32  # the backend waits for more keyframes than this


def backend_device(tracker, count=None):
    """The asynchronous backend's device: the first card other than the
    tracker's when the machine has more than one (``count``, by default
    ``torch.cuda.device_count()``), else the tracker's own."""
    tracker = torch.device(tracker)
    if tracker.type != "cuda":
        return tracker
    count = torch.cuda.device_count() if count is None else count
    if count < 2:
        return tracker
    return torch.device("cuda", 1 if (tracker.index or 0) == 0 else 0)


@contextlib.contextmanager
def after_tracker_writes(stream, tracker=None):
    """For work issued inside on ``stream`` (the thread's current stream,
    or None on the CPU): it starts after the work already issued on the
    tracker's default stream (on ``tracker``, by default the stream's
    device), and that stream's later work starts after it."""
    if stream is None:
        yield
        return
    default = torch.cuda.default_stream(tracker or stream.device)
    stream.wait_stream(default)
    yield
    default.wait_stream(stream)


def merge_frames(video2, t0, poses1, frames):
    """Write the tracker's frames [t0, t1) into the backend's video, in its
    frame. poses1: the tracker's poses [0, t1); frames: ``read_frames(t0,
    t1)`` of the tracker's video (its poses and disparities replaced here).
    The tracker's poses over [max(t0-10, 0), t0-1) are aligned to the
    backend's (droid_slam_tpu/slam/async_droid.py:104-124): the scale only
    for monocular input without sensor depth. Returns (dG [1,7], s)."""
    dev = poses1.device
    if t0 > 0:
        lo = max(t0 - 10, 0)
        dG, s = align_pose_fragments(poses1[lo:t0 - 1],
                                     video2.poses[lo:t0 - 1])
        if video2.stereo or bool(frames["disps_sens"].any()):
            s = torch.ones((), device=dev)
    else:
        dG, s = se3.identity((1,), device=dev), torch.ones((), device=dev)
    t1 = poses1.shape[0]
    p = poses1[t0:t1]
    frames["poses"] = se3.mul(dG, torch.cat([p[:, :3] * s, p[:, 3:]], -1))
    frames["disps"] = frames["disps"] / s
    video2.write_frames(t0, frames)
    return dG, s


class DroidAsync(TrackPipeline):
    def __init__(self, config: DroidConfig, sleep_time: float = 10.0,
                 backend_iters: int = 8, device="cuda"):
        super().__init__(config, device)
        bdev = backend_device(self.device)
        self._stream = (torch.cuda.Stream(bdev) if bdev.type == "cuda"
                        else None)
        params2 = {k: v.to(bdev) for k, v in self.params.items()}
        # allocated on the backend's stream, which uses them: memory the
        # caching allocator handed out on the default stream would go back
        # to the tracker when the backend frees it, while the backend's
        # kernels might still run on it
        with torch.cuda.stream(self._stream):
            self.video2 = DepthVideo(config.image_size, config.buffer,
                                     bdev, stereo=config.stereo,
                                     upsample=config.upsample)
            self.backend = DroidAsyncBackend(params2, self.video2, config)
        self.traj_filler = PoseTrajectoryFiller(
            params2, self.video2, fused_epilogue=config.gru_fused_epilogue)
        self.sleep_time = sleep_time
        self.backend_iters = backend_iters
        # per backend cycle: t0, t1, scale, dG, edges, start (wall clock),
        # seconds
        self.cycles = []
        self.terminate_stats = None
        self._error = None
        self._wake = threading.Event()
        self._thread = threading.Thread(target=self._backend_loop,
                                        name="droid-backend", daemon=True)
        self._thread.start()

    @property
    def backend_cycles(self):
        return len(self.cycles)

    def _raise_backend_error(self):
        if self._error is not None:
            raise RuntimeError("the backend thread failed") from self._error

    def track(self, tstamp, image, depth=None, intrinsics=None):
        self._raise_backend_error()
        super().track(tstamp, image, depth, intrinsics)

    @torch.no_grad()
    def _sync_and_run_backend(self, is_last: bool):
        """One backend cycle (droid_slam_tpu/slam/async_droid.py:69-131):
        snapshot, merge, ``backend_iters`` global-BA steps. Returns the
        cycle's record, or None when there is nothing new."""
        start, tic = time.time(), time.perf_counter()
        v1, v2 = self.video, self.video2
        t0 = max(v2.counter - 2, 0)
        with v1.get_lock(), after_tracker_writes(self._stream, v1.device):
            t1 = v1.counter if is_last else v1.counter - 5
            if t1 <= t0:
                return None
            poses1 = v1.poses[:t1].to(v2.device, copy=True)
            frames = {k: x.to(v2.device) if torch.is_tensor(x) else x
                      for k, x in v1.read_frames(t0, t1).items()}
        dG, s = merge_frames(v2, t0, poses1, frames)
        edges = self.backend(self.backend_iters, normalize=False)
        if self._stream is not None:
            self._stream.synchronize()
        cycle = dict(t0=t0, t1=t1, scale=float(s), dG=dG.cpu().numpy(),
                     edges=edges, start=start, s=time.perf_counter() - tic)
        self.cycles.append(cycle)
        return cycle

    def _backend_loop(self):
        try:
            with torch.cuda.stream(self._stream):
                while True:
                    is_last = self.video2.ready
                    if self.video.counter > START_KEYFRAMES or is_last:
                        with f32_matmuls():
                            self._sync_and_run_backend(is_last)
                        if is_last:
                            return
                    self._wake.wait(self.sleep_time)
        except BaseException as e:  # re-raised by track() and terminate()
            self._error = e

    @torch.no_grad()
    @_f32_matmuls
    def terminate(self, stream=None, backend_steps=None, join_timeout=600.0):
        """Finish tracking, let the backend run its last cycle over every
        keyframe, and fill in the poses of the stream's frames from the
        backend's video (``Droid.terminate``'s contract). ``backend_steps``
        is taken for the facades' common signature and ignored: the
        backend runs ``backend_iters`` steps per cycle. Raises when the
        backend thread failed or did not finish within ``join_timeout`` s.

        ``terminate_stats``: ``backend_cycles`` (before this call),
        ``final_cycle_s`` (the flush and the backend's last cycle),
        ``filler_s``, ``total_s``."""
        t_all = time.perf_counter()
        self.flush()
        cycles = len(self.cycles)
        self.video2.ready = True
        self._wake.set()
        self._thread.join(timeout=join_timeout)
        if self._thread.is_alive():
            raise TimeoutError(f"the backend thread did not finish within "
                               f"{join_timeout} s")
        self._raise_backend_error()
        final_s = time.perf_counter() - t_all

        tic = time.perf_counter()
        if stream is not None:
            traj = torch.as_tensor(self.traj_filler(stream))
        else:
            traj = self.video2.poses[:self.video2.counter].cpu()
        self._sync()
        if self.video2.device != self.device:
            torch.cuda.synchronize(self.video2.device)
        out = se3.inv(se3.normalize(traj)).numpy()
        self.terminate_stats = dict(
            backend_cycles=cycles, final_cycle_s=final_s,
            filler_s=time.perf_counter() - tic,
            total_s=time.perf_counter() - t_all)
        return out
