"""Droid: the user-facing tracker, for monocular, stereo and RGB-D input.

Counterpart of ``droid_slam_tpu/slam/droid.py`` (``TrackPipeline``,
``Droid.__init__``, ``track``, ``flush``, ``terminate``). Two paths, as in
JAX:
  * strict: each arriving frame first resolves the previous frame's
    keyframe and admission decisions, then runs the frontend update, then
    begins this frame's admission test (JAX's path on the CPU);
  * the frame path (``DroidConfig.fused_frame``, on by default on CUDA):
    after the initialization each frame is the two frame programs of
    ``slam/fused_frame.py`` (on CUDA, two CUDA graph replays) built from
    the previous frame's one readback; with ``spec_frame`` (off unless
    asked for) they are dispatched before that readback is read, and
    a mis-speculated frame is unwound on the host (its device writes were
    gated off), or after a keyframe removal run again with forced gates.
``terminate()`` runs the global BA passes and the trajectory filler.
``TrackPipeline`` is the tracking half, which the asynchronous facades
(``slam/async_droid.py``, ``slam/async_process.py``) share.

Under a running ``torch.profiler`` (``utils/trace.py``) a call is the span
``droid:track`` (args: tstamp), with ``droid:strict`` (the strict path and
``flush``), ``droid:resolve`` (the previous readback, keyframe removal,
admission), ``droid:update_host``, ``droid:pack`` (the deferred moves and
the frame's tables), ``droid:dispatch``, ``droid:readback_wait``,
``droid:capture`` and ``droid:spec_unwind`` inside it.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time

import numpy as np
import torch

from ..config import DroidConfig
from ..lie import se3
from ..models import weights as weights_io
from ..state.graph import SlotGraph
from ..state.video import DepthVideo
from ..utils import trace
from . import fused_frame
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


def frame_path(config: DroidConfig, device):
    """(fused_frame, spec_frame) of a tracker on ``device``: the frame
    programs by default on CUDA, off on the CPU, as JAX's rule
    (droid_slam_tpu/slam/droid.py:55-80,418-420); speculation only when
    asked for (JAX's rule turns it on with the frame programs: on the
    H100 the synthetic evaluation's trajectory then collapsed, ROADMAP.md
    §3 item 16); ``edge_parallel`` turns both off."""
    on_cuda = torch.device(device).type == "cuda"
    fused = on_cuda if config.fused_frame is None else config.fused_frame
    fused = bool(fused) and not config.edge_parallel
    return fused, fused and bool(config.spec_frame)


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
        self.frontend.motion_filter = self.filterx
        self.filterx.proximity_probe = self.frontend.proximity_pairs

        self._fused_frame, self._spec_frame = frame_path(config, device)
        f = self.frontend
        self.frame_programs = (None if not self._fused_frame else
                               fused_frame.FramePrograms(
                                   self.video, fused_frame.Consts(
                                       beta=f.beta,
                                       motion_damping=f.motion_damping,
                                       kf_thresh=f.keyframe_thresh,
                                       adm_thresh=self.filterx.thresh,
                                       keep_thresh=2.0 * f.keyframe_thresh)))
        self._pending_vec = None     # the last part A's Readback
        self._pending_ran_upd = False
        self._spec_meta = None
        self._dist_ring = {}         # probed distances by their pairs' key
        self._delta_log = []         # admission deltas read back
        # speculation outcomes: frames unwound, frames run again after a
        # keyframe removal, proposals without their probed distances
        self.spec_mis = self.strict_reruns = self.spec_dist_miss = 0
        # the frame path, from values the host already holds: read-back
        # deltas above the filter's threshold; frame programs that ran an
        # update and their live edges at dispatch; update iterations the
        # programs ran, and those whose writes were kept (``iters1``, and
        # ``iters2`` when the keyframe stayed, once the readback says so)
        self.admitted = self.updates = self.update_edges = 0
        self.iters_run = self.iters_kept = 0

    @torch.no_grad()
    @_f32_matmuls
    def track(self, tstamp, image, depth=None, intrinsics=None):
        """image: uint8 BGR [H,W,3], or with ``config.stereo`` a rectified
        stack [2,H,W,3], left view first; depth: None, or a depth map
        [H,W] f32 (RGB-D; values <= 0 mark pixels without depth);
        intrinsics [fx, fy, cx, cy] at full resolution."""
        with trace.span("track", {"tstamp": float(tstamp)}):
            if (self._fused_frame and self.frontend.is_initialized
                    and self.filterx._pending is not None
                    and len(self.frontend.graph.ii)):
                if (self._spec_frame and self._pending_vec is not None
                        and self._spec_meta is not None):
                    self._track_fused_spec(tstamp, image, depth, intrinsics)
                else:
                    self._track_fused(tstamp, image, depth, intrinsics)
                return
            with trace.span("strict"):
                self._resolve_prev()
                self.frontend()
                self.filterx.track_begin(tstamp, image, depth, intrinsics)

    def _resolve_prev(self, defer=False):
        """Resolve the previous frame's keyframe distance and admission,
        from the frame program's readback when one is pending. Returns the
        keyframe write with ``defer``."""
        with trace.span("resolve"):
            if self._pending_vec is not None:
                vec = self._pending_vec.numpy()
                self._pending_vec = None
                self._count_readback(vec, self._pending_ran_upd)
                self._delta_log.append(float(vec[1]))
                self.frontend.finalize(
                    kf_value=float(vec[0]) if self._pending_ran_upd
                    else None)
                return self.filterx.track_finish(
                    defer=defer, resolved=(float(vec[1]), vec[2:]))
            self.frontend.finalize()
            if defer:
                return self.filterx.track_finish(defer=True)
            return self.filterx.track_finish()

    def _count_readback(self, vec, ran_upd):
        """The counters a frame program's readback settles: its admission,
        and with an update the iterations whose writes were kept."""
        f = self.frontend
        self.admitted += float(vec[1]) > self.filterx.thresh
        if ran_upd:
            kept = float(vec[0]) >= 2.0 * f.keyframe_thresh
            self.iters_kept += f.iters1 + (f.iters2 if kept else 0)

    # ------------------------------------------------------------------
    # the frame path (droid_slam_tpu/slam/droid.py:108-413)
    # ------------------------------------------------------------------

    def _slot_graph(self):
        """The frontend's graph as a ``SlotGraph`` (once, after the
        initialization, as JAX's ``compact()`` leaves it)."""
        f = self.frontend
        if not isinstance(f.graph, SlotGraph):
            f.graph = SlotGraph.from_graph(f.graph)
        return f.graph

    def _fused_build_and_dispatch(self, tstamp, img, depth, intrinsics, wf,
                                  spec_mode=0):
        """The tables of one frame, and its two programs; ``spec_mode``:
        the speculation gates that are live (``fused_frame.spec_gate``)."""
        f, mf, v = self.frontend, self.filterx, self.video
        g = f.graph
        g.defer = True
        try:
            run_upd = f.t1 < v.counter
            tb = (f.update_host() if run_upd
                  else g.update_tables(use_inactive=True))
            pi, pj = mf.track_begin(tstamp, img, depth, intrinsics,
                                    defer=True)
        finally:
            g.defer = False
        with trace.span("pack"):
            mv_src, mv_dst, ae_ii, ae_jj, ae_c, ae_slots = \
                g.drain_deferred()
            wf_index, values, fields = wf
            if not set(fields) <= fused_frame.FIELDS:
                raise ValueError(f"a frame program writes "
                                 f"{fused_frame.FIELDS}, not {fields}")
            enc = self.frame_programs.enc
            for buf, name in zip(enc.bufs(), ("fmaps", "nets", "inps")):
                if values[name] is not buf:   # the strict path's last encode
                    buf.copy_(values[name])
            up_dst = (g.up_dst_table(tb) if g.upsample
                      else np.zeros(tb["nw"], np.int64))
            ints = np.concatenate([np.asarray(a, np.int64).reshape(-1)
                                   for a in (
                [wf_index, v.counter - 1, f.iters1 if run_upd else 0,
                 f.iters2 if run_upd else 0, int(run_upd), spec_mode,
                 f.probe_lead], mv_src, mv_dst, ae_ii, ae_jj, ae_c, ae_slots,
                up_dst, pi, pj)] + [tb["packed"]]).astype(np.int32)
            floats = np.concatenate([[values["tstamp"]],
                                     values["intrinsics"]]).astype(np.float32)
            key = fused_frame.FrameKey(
                ea=g.capacity, ib=tb["IB"], kb=len(ae_ii), nw=tb["nw"],
                pb=len(pi), ba_shape=tuple(tb["ba_shape"]), fields=fields,
                iters1=f.iters1, iters2=f.iters2, upsample=g.upsample,
                with_volumes=g.pyr_e is not None,
                fused_epilogue=g.fused_epilogue, generation=g.generation)
        self.iters_run += key.iters1 + key.iters2
        if run_upd:
            self.updates += 1
            self.update_edges += len(g.ii)
        # the lock across both programs: the asynchronous backend reads the
        # video under it (droid_slam_tpu/slam/droid.py:176-185)
        with v.get_lock():
            out = self.frame_programs.run(
                g, key, ints, floats, np.asarray(img),
                values.get("disps_sens"))
        self._pending_vec = out
        self._pending_ran_upd = run_upd
        self._spec_meta = dict(ran_upd=run_upd, probe_key=f._probe_key,
                               n_pairs=mf._pending[-1])
        if run_upd:
            g.bump_age(f.iters1)
        mf.track_begin_complete(*enc.bufs())

    def _track_fused(self, tstamp, image, depth, intrinsics):
        """A frame with the previous readback resolved first."""
        img = self._views(image)
        self._slot_graph()
        wf = self._resolve_prev(defer=True)
        self.frontend.probe_lead = 2 if self._spec_frame else 1
        self._fused_build_and_dispatch(tstamp, img, depth, intrinsics, wf)

    @staticmethod
    def _views(image):
        img = np.asarray(image)
        return img[None] if img.ndim == 3 else img

    def _spec_snapshot(self):
        """The host bookkeeping a mis-speculation unwinds (the device's
        writes were gated off)."""
        f, mf, v = self.frontend, self.filterx, self.video
        g = f.graph
        return dict(
            ii=g.ii.copy(), jj=g.jj.copy(), age=g.age.copy(),
            slots=g.slots.copy(), free=list(g.free),
            ii_inac=g.ii_inac.copy(), jj_inac=g.jj_inac.copy(),
            inac_slots=g.inac_slots.copy(), inac_free=list(g.inac_free),
            t1=f.t1, count=f.count, probe_key=f._probe_key,
            counter=v.counter, dirty=v.dirty.copy(),
            img_slot=(v.counter, v.images[v.counter]
                      if v.counter < len(v.images) else None),
            mf_count=mf.count, mf_fmap=mf.fmap, mf_net=mf.net, mf_inp=mf.inp,
            mf_pending=mf._pending, mf_pending_distance=mf.pending_distance)

    def _spec_restore(self, s):
        f, mf, v = self.frontend, self.filterx, self.video
        g = f.graph
        for k in ("ii", "jj", "age", "slots", "ii_inac", "jj_inac",
                  "inac_slots"):
            setattr(g, k, s[k].copy())
        g.free, g.inac_free = list(s["free"]), list(s["inac_free"])
        f.t1, f.count, f._probe_key = s["t1"], s["count"], s["probe_key"]
        v.counter, v.dirty = s["counter"], s["dirty"].copy()
        idx, old_img = s["img_slot"]
        if idx < len(v.images):
            v.images[idx] = old_img
        mf.count = s["mf_count"]
        mf.fmap, mf.net, mf.inp = s["mf_fmap"], s["mf_net"], s["mf_inp"]
        mf.pending_distance = s["mf_pending_distance"]

    def _track_fused_spec(self, tstamp, image, depth, intrinsics):
        """A frame dispatched before the previous readback is read
        (droid_slam_tpu/slam/droid.py:297-404): the previous keyframe is
        taken as kept and the previous frame as admitted; the readback is
        then read while the device works, and a wrong guess is unwound:
          * previous frame rejected: the gates dropped every write of this
            frame, whose encode (against the right keyframe) stands;
          * keyframe removal: this frame runs again with forced gates
            (a strict re-run, counted in ``strict_reruns``).
        The proposal's distances come from the probe one frame earlier
        (``probe_lead`` 2): one update staler than the strict path's."""
        f, mf, v = self.frontend, self.filterx, self.video
        meta_prev, vec_prev = self._spec_meta, self._pending_vec
        img = self._views(image)
        snap = self._spec_snapshot()

        # guess: the previous update's keyframe kept (inf: a finite stand-in
        # could trigger a real removal), the previous frame admitted
        f.finalize(kf_value=float("inf") if meta_prev["ran_upd"] else None)
        self._pending_vec = None
        wf = mf.track_finish(defer=True,
                             resolved=(np.inf, np.zeros(0, np.float32)))
        key = (v.counter, f.t1 + 1)
        if key in self._dist_ring:
            mf.pending_distance = self._dist_ring[key]
            f._probe_key = key
        else:
            f._probe_key = None
            self.spec_dist_miss += 1
        f.probe_lead = 2
        self._fused_build_and_dispatch(
            tstamp, img, depth, intrinsics, wf,
            spec_mode=1 | (2 if meta_prev["ran_upd"] else 0))

        # resolve the previous readback while the device works
        with trace.span("resolve"):
            vec = vec_prev.numpy()
            self._count_readback(vec, meta_prev["ran_upd"])
            self._delta_log.append(float(vec[1]))
            if meta_prev["probe_key"] is not None:
                self._dist_ring[meta_prev["probe_key"]] = \
                    vec[2:2 + meta_prev["n_pairs"]].copy()
                while len(self._dist_ring) > 4:
                    self._dist_ring.pop(next(iter(self._dist_ring)))
            keep_ok = (not meta_prev["ran_upd"]) or \
                float(vec[0]) >= 2.0 * f.keyframe_thresh
            admit_ok = float(vec[1]) > mf.thresh
        if keep_ok and admit_ok:
            return
        with trace.span("spec_unwind"):
            self.spec_mis += 1
            cur_meta, cur_vec = self._spec_meta, self._pending_vec
            self._spec_restore(snap)
            if keep_ok:
                # the previous frame was rejected: this frame's writes were
                # dropped and its encode stands
                mf.count = snap["mf_count"] + 1
                self._pending_vec = cur_vec
                self._pending_ran_upd = False
                self._spec_meta = dict(cur_meta, ran_upd=False)
                return

            # keyframe removal: resolve strictly and run the frame again,
            # with the previous frame's encode back in place
            self.strict_reruns += 1
            enc = self.frame_programs.enc
            for buf, prev in zip(enc.bufs(), enc.prev):
                buf.copy_(prev)
            mf._pending = snap["mf_pending"]
            self._pending_vec = self._spec_meta = None
            f.finalize(kf_value=float(vec[0]))
            wf = mf.track_finish(defer=True,
                                 resolved=(float(vec[1]), vec[2:]))
            self._fused_build_and_dispatch(tstamp, img, depth, intrinsics,
                                           wf)

    @torch.no_grad()
    @_f32_matmuls
    def flush(self):
        """Resolve the last frame's admission and run its update."""
        self._spec_meta = None
        with trace.span("strict"):
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
