"""DroidAsyncProcess: tracking with the global BA in a separate process.

Counterpart of ``droid_slam_tpu/slam/async_process.py``, with the state
exchanged as the reference's ``depth_video.py`` exchanged it: tensors on the
video's device shared with ``share_memory_()`` (CUDA IPC on the card, shared
memory on the CPU) and guarded by ``multiprocessing`` locks, in two slabs:
- the input slab, every frame field of ``DepthVideo.FRAME_FIELDS`` [B, ...],
  which a pusher thread of the tracker fills every ``push_time`` seconds
  under ``in_lock``: the poses and disparities of every keyframe, and the
  other fields from the backend's next t0 (its published count less 2) to
  the tracker's count, so a keyframe the tracker removed after an earlier
  push leaves no stale slot behind; the pushes are numbered, and each
  backend cycle records the number of the push it merged;
- the output slab, the backend's poses and disparities, which the backend
  publishes after each cycle under ``out_lock``.
The backend process (``spawn``: CUDA cannot fork) imports only this package
(the tracker builds the kernel library before the spawn, so the backend
never builds it), polls the input count, merges the new keyframes into its
own video as the thread facade does (``merge_frames``), runs
``DroidAsyncBackend`` and publishes.
``terminate()`` pushes the last keyframes, sets ``ready`` for the backend's
last cycle, and rebuilds the backend's video from both slabs for the
trajectory filler. A failure of the backend process or of the pusher
surfaces as an exception in the tracker's process; a backend that does not
finish within ``join_timeout`` is killed and raises.
"""

from __future__ import annotations

import os
import threading
import time
import traceback

import torch
import torch.multiprocessing as tmp

from ..config import DroidConfig
from ..lie import se3
from ..models import weights as weights_io
from ..ops import _build
from ..state.video import DepthVideo
from .async_droid import START_KEYFRAMES, after_tracker_writes, merge_frames
from .backend import DroidAsyncBackend
from .droid import TrackPipeline, _f32_matmuls, f32_matmuls
from .trajectory_filler import PoseTrajectoryFiller

# the backend's intra-op threads: its host work is one interpreter loop, and
# it shares the machine's cores with the tracker
BACKEND_THREADS = 2


def _new_slab(video):
    """Shared zeroed copies of the video's frame fields, and the backend's
    output poses and disparities."""
    slab = {name: torch.zeros_like(getattr(video, name))
            for name in DepthVideo.FRAME_FIELDS}
    slab["out_poses"] = torch.zeros_like(video.poses)
    slab["out_disps"] = torch.zeros_like(video.disps)
    for t in slab.values():
        t.share_memory_()
    return slab


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _backend_main(cfg, device, slab, ctl, events, sleep_time, backend_iters,
                  deterministic, parent_pid):
    """The backend process: poll -> copy -> merge -> global BA -> publish.
    Sends ("cycle", record) after each cycle and ("error", traceback) on
    failure to ``events``; returns when its parent is gone. It takes the
    tracker's choice of ``torch.use_deterministic_algorithms``."""
    try:
        torch.set_num_threads(BACKEND_THREADS)
        torch.use_deterministic_algorithms(deterministic)
        device = torch.device(device)
        params = weights_io.load(cfg.weights, device)
        v2 = DepthVideo(cfg.image_size, cfg.buffer, device,
                        stereo=cfg.stereo, upsample=cfg.upsample)
        backend = DroidAsyncBackend(params, v2, cfg)
        ctl["started_at"].value = time.time()

        def publish():
            t = v2.counter
            with ctl["out_lock"]:
                slab["out_poses"][:t] = v2.poses[:t]
                slab["out_disps"][:t] = v2.disps[:t]
                _sync(device)
                ctl["counter_out"].value = t

        with torch.no_grad():
            while True:
                is_last = ctl["ready"].value == 1
                t_in = ctl["counter_in"].value
                if os.getppid() != parent_pid:
                    return
                if t_in > START_KEYFRAMES or is_last:
                    start, tic = time.time(), time.perf_counter()
                    t0 = max(v2.counter - 2, 0)
                    t1 = t_in if is_last else t_in - 5
                    if t1 > t0:
                        with ctl["in_lock"]:
                            push = ctl["pushes"].value
                            poses1 = slab["poses"][:t1].clone()
                            frames = {name: slab[name][t0:t1].clone()
                                      for name in DepthVideo.FRAME_FIELDS}
                            _sync(device)
                        with f32_matmuls():
                            _, s = merge_frames(v2, t0, poses1, frames)
                            edges = backend(backend_iters, normalize=False)
                        publish()
                        ctl["cycles"].value += 1
                        peak = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
                        events.put(("cycle", dict(
                            t0=t0, t1=t1, push=push, scale=float(s),
                            edges=edges, start=start,
                            s=time.perf_counter() - tic,
                            peak_gb=peak / 2 ** 30)))
                    if is_last:
                        publish()
                        ctl["done"].value = 1
                        return
                ctl["wake"].wait(sleep_time)
    except BaseException:
        events.put(("error", traceback.format_exc()))
        raise
    finally:
        # the process ends without a collection: give the shared tensors
        # back to their producer now
        slab.clear()


class DroidAsyncProcess(TrackPipeline):
    def __init__(self, config: DroidConfig, sleep_time: float = 10.0,
                 push_time: float | None = None, backend_iters: int = 8,
                 device="cuda"):
        super().__init__(config, device)
        if self.device.type == "cuda":
            _build.build()
        self._slab = _new_slab(self.video)
        ctx = tmp.get_context("spawn")
        self._ctl = {
            "counter_in": ctx.Value("i", 0),
            "counter_out": ctx.Value("i", 0),
            "ready": ctx.Value("i", 0),
            "done": ctx.Value("i", 0),
            "cycles": ctx.Value("i", 0),
            "pushes": ctx.Value("i", 0),
            "started_at": ctx.Value("d", 0.0),
            "in_lock": ctx.Lock(),
            "out_lock": ctx.Lock(),
            "wake": ctx.Event(),
        }
        self._events = ctx.SimpleQueue()
        # per backend cycle: t0, t1, the number of the push it merged,
        # scale, edges, start (wall clock), seconds, the backend's peak
        # device GiB so far
        self.cycles = []
        self._child_error = None
        self.terminate_stats = None
        self._spawned_at = time.time()
        self._proc = ctx.Process(
            target=_backend_main, name="droid-backend", daemon=True,
            args=(config, str(self.device), self._slab, self._ctl,
                  self._events, sleep_time, backend_iters,
                  torch.are_deterministic_algorithms_enabled(), os.getpid()))
        self._proc.start()

        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._push_error = None
        self._push_stop = threading.Event()
        self._push_thread = threading.Thread(
            target=self._push_loop, name="droid-pusher", daemon=True,
            args=(sleep_time if push_time is None else push_time,))
        self._push_thread.start()

    @property
    def backend_cycles(self):
        return self._ctl["cycles"].value

    @property
    def backend_startup_s(self):
        """Seconds from the spawn to the backend's video and weights being
        ready (0 until then)."""
        started = self._ctl["started_at"].value
        return started - self._spawned_at if started else 0.0

    def _drain(self):
        """Take the backend's cycle records and error off its queue."""
        while not self._events.empty():
            kind, value = self._events.get()
            if kind == "cycle":
                self.cycles.append(value)
            else:
                self._child_error = value

    def _check(self):
        """Raise if the pusher or the backend process failed; a backend
        left running without its pusher is stopped first."""
        if self._push_error is not None:
            self._proc.kill()
            raise RuntimeError("the pusher thread failed") \
                from self._push_error
        code = self._proc.exitcode
        if self._child_error is not None or code not in (None, 0):
            raise RuntimeError(f"the backend process failed (exit code "
                               f"{code}):\n{self._child_error or ''}")

    def track(self, tstamp, image, depth=None, intrinsics=None):
        self._check()
        super().track(tstamp, image, depth, intrinsics)

    @torch.no_grad()
    def _push(self):
        """Copy the tracker's keyframes into the input slab (module doc);
        returns the (t0, t1) of the frame fields other than the poses and
        disparities, which it copies over [0, t1)."""
        v, slab, ctl = self.video, self._slab, self._ctl
        with torch.cuda.stream(self._stream):
            with v.get_lock(), after_tracker_writes(self._stream):
                t1 = v.counter
                t0 = min(max(ctl["counter_out"].value - 2, 0), t1)
                poses, disps = v.poses[:t1].clone(), v.disps[:t1].clone()
                frames = v.read_frames(t0, t1)
            with ctl["in_lock"]:
                slab["poses"][:t1] = poses
                slab["disps"][:t1] = disps
                for name in DepthVideo.FRAME_FIELDS:
                    if name not in ("poses", "disps"):
                        slab[name][t0:t1] = frames[name]
                if self._stream is not None:
                    self._stream.synchronize()
                ctl["counter_in"].value = t1
                ctl["pushes"].value += 1
        return t0, t1

    def _push_loop(self, period):
        try:
            while not self._push_stop.wait(period):
                self._push()
                self._drain()
        except BaseException as e:  # re-raised by track() and terminate()
            self._push_error = e

    @torch.no_grad()
    @_f32_matmuls
    def terminate(self, stream=None, backend_steps=None, join_timeout=600.0):
        """``DroidAsync.terminate``'s contract: the last push, the backend's
        last cycle over every keyframe, then the filler on the backend's
        video rebuilt from the slabs (kept as ``video2``). Raises when the
        pusher or the backend failed, or the backend did not finish within
        ``join_timeout`` s."""
        t_all = time.perf_counter()
        self.flush()
        self._push_stop.set()
        self._push_thread.join(timeout=60)
        if self._push_thread.is_alive():
            self._proc.kill()
            raise TimeoutError("the pusher thread did not stop within 60 s")
        self._drain()
        self._check()
        cycles = self._ctl["cycles"].value
        self._push()
        self._ctl["ready"].value = 1
        self._ctl["wake"].set()
        deadline = time.time() + join_timeout
        while not self._ctl["done"].value and self._proc.is_alive():
            if time.time() > deadline:
                self._proc.kill()
                self._proc.join()
                raise TimeoutError(f"the backend process did not finish "
                                   f"within {join_timeout} s")
            self._drain()
            time.sleep(0.05)
        self._proc.join(timeout=60)
        self._drain()
        self._check()
        if self._proc.is_alive() or not self._ctl["done"].value:
            raise RuntimeError("the backend process ended without its last "
                               "cycle")
        final_s = time.perf_counter() - t_all

        tic = time.perf_counter()
        self.video2 = video2 = self._backend_video()
        if stream is not None:
            filler = PoseTrajectoryFiller(
                self.params, video2,
                fused_epilogue=self.config.gru_fused_epilogue)
            traj = torch.as_tensor(filler(stream))
        else:
            traj = video2.poses[:video2.counter].cpu()
        self._sync()
        self._slab = None
        out = se3.inv(se3.normalize(traj)).numpy()
        self.terminate_stats = dict(
            backend_cycles=cycles, final_cycle_s=final_s,
            filler_s=time.perf_counter() - tic,
            total_s=time.perf_counter() - t_all,
            startup_s=self.backend_startup_s)
        return out

    def _backend_video(self):
        """The backend's keyframes as a video: its poses and disparities
        from the output slab, the other fields from the input slab."""
        slab, t = self._slab, self._ctl["counter_out"].value
        frames = {name: slab[name][:t] for name in DepthVideo.FRAME_FIELDS}
        frames["poses"] = slab["out_poses"][:t]
        frames["disps"] = slab["out_disps"][:t]
        cfg = self.config
        video2 = DepthVideo(cfg.image_size, cfg.buffer, self.device,
                            stereo=cfg.stereo, upsample=cfg.upsample)
        video2.write_frames(0, frames)
        return video2
