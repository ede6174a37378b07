"""DroidFrontend: local sliding-window tracking.

Counterpart of ``droid_slam_tpu/slam/frontend.py`` on its per-call path:
warm-up initialization (neighborhood + proximity edges, 2 x 8 update
iterations), then per keyframe: age-based eviction, proximity edges,
``iters1`` updates, the keyframe-distance probe, and, when the keyframe is
kept, ``iters2`` more updates and the motion model for the next frame. The
keyframe decision is applied one frame late (``finalize``), as in the JAX
pipeline, so that edge sets match it after ``flush``. With a depth sensor,
each keyframe update first gives the newest keyframe its sensor disparity
(``sens_frame``; the initialization does not, as in JAX).

On the frame path (``slam/fused_frame.py``) the graph is a ``SlotGraph``
and the update splits as JAX's does (droid_slam_tpu/slam/frontend.py:
86-195): ``update_host`` does the bookkeeping and builds the tables, the
frame program runs them, and ``finalize(kf_value=...)`` applies the
keyframe distance the program read back. The proximity proposal then takes
the distances the previous program probed (``proximity_pairs``), when they
are for this update's pairs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geom import distance as gdist
from ..lie import se3
from ..parallel.frontend import edge_parallel_mesh
from ..state.graph import FactorGraph, SlotGraph
from ..utils import trace


class DroidFrontend:
    def __init__(self, params, video, cfg, edge_devices=None):
        """With ``cfg.edge_parallel`` = N the graph's updates run edge-
        parallel over N devices (droid_slam_tpu/slam/frontend.py:55-62):
        ``edge_devices`` when given, else cuda:0..N-1."""
        self.video = video
        mesh = None
        if cfg.edge_parallel:
            mesh = edge_parallel_mesh(cfg.edge_parallel, edge_devices)
        elif edge_devices is not None:
            raise ValueError("edge_devices needs DroidConfig.edge_parallel")
        self.graph = FactorGraph(video, params, max_factors=48,
                                 fused_epilogue=cfg.gru_fused_epilogue,
                                 upsample=cfg.upsample, mesh=mesh)
        self.t1 = 0
        self.is_initialized = False
        self.max_age = 20
        self.iters1 = 3
        self.iters2 = 2
        self.warmup = cfg.warmup
        self.beta = cfg.beta
        self.frontend_nms = cfg.frontend_nms
        self.keyframe_thresh = cfg.keyframe_thresh
        self.frontend_window = cfg.frontend_window
        self.frontend_thresh = cfg.frontend_thresh
        self.frontend_radius = cfg.frontend_radius
        self.motion_damping = max(cfg.motion_damping, 0.0)
        self._pending_kf = None  # keyframe distance awaiting finalize()
        # the frame path: frames updated, the filter whose probe distances
        # the proposal takes, the key of the pairs last probed, and how many
        # frames ahead the probe looks (2 under speculative dispatch)
        self.count = 0
        self.motion_filter = None
        self._probe_key = None
        self.probe_lead = 1

    def proximity_pairs(self):
        """The pairs of a later update's proximity proposal, for the frame
        program to probe (droid_slam_tpu/slam/frontend.py:86-107): the
        update ``probe_lead`` frames ahead, whose newest frames' poses the
        program extrapolates with the motion model."""
        if not self.is_initialized:
            self._probe_key = None
            return np.zeros(1, np.int64), np.zeros(1, np.int64)
        t = self.video.counter + self.probe_lead
        t1n = self.t1 + self.probe_lead
        ii, jj = np.meshgrid(np.arange(t1n - 5, t),
                             np.arange(max(t1n - self.frontend_window, 0), t),
                             indexing="ij")
        self._probe_key = (t, t1n)
        return ii.reshape(-1), jj.reshape(-1)

    def update_host(self):
        """The host half of an update on the frame path: eviction, the
        proximity proposal (with the probed distances when their key
        matches) and the tables (``SlotGraph.update_tables``); the span
        ``droid:update_host``."""
        with trace.span("update_host"):
            self.count += 1
            self.t1 += 1
            g = self.graph
            if len(g.ii):
                g.rm_factors(g.age > self.max_age, store=True)
            mf, dist = self.motion_filter, None
            if (mf is not None and mf.pending_distance is not None
                    and self._probe_key == (self.video.counter, self.t1)):
                dist = mf.pending_distance
            g.add_proximity_factors(
                self.t1 - 5, max(self.t1 - self.frontend_window, 0),
                rad=self.frontend_radius, nms=self.frontend_nms,
                thresh=self.frontend_thresh, beta=self.beta, remove=True,
                dist=dist)
            tb = g.update_tables(use_inactive=True,
                                 kf_pair=(self.t1 - 4, self.t1 - 2),
                                 next_state_t1=self.t1,
                                 sens_frame=self.t1 - 1)
            self.video.dirty[int(g.ii.min()):self.t1] = True
            return tb

    def _init_next_state(self):
        """Motion model and median disparity for the incoming frame t1."""
        v, t1 = self.video, self.t1
        p_prev = v.poses[t1 - 1]
        vel = se3.log(se3.mul(p_prev, se3.inv(v.poses[t1 - 2])))
        v.poses[t1] = se3.mul(se3.exp(self.motion_damping * vel), p_prev)
        v.disps[t1] = torch.quantile(v.disps[t1 - 3:t1 - 1], 0.5)

    def _update(self):
        if isinstance(self.graph, SlotGraph):
            # the frame path's update outside a frame program (flush)
            from .fused_frame import update_step
            self._pending_kf = update_step(self, self.update_host())
            return
        self.t1 += 1
        g = self.graph
        if len(g.ii):
            g.rm_factors(g.age > self.max_age, store=True)
        g.add_proximity_factors(
            self.t1 - 5, max(self.t1 - self.frontend_window, 0),
            rad=self.frontend_radius, nms=self.frontend_nms,
            thresh=self.frontend_thresh, beta=self.beta, remove=True)
        # the frames this update may move, for the viewer
        # (droid_slam_tpu/slam/frontend.py:151)
        self.video.dirty[int(g.ii.min()):self.t1] = True
        g.update(None, None, use_inactive=True, n_iters=self.iters1,
                 sens_frame=self.t1 - 1)

        v = self.video
        pair = torch.tensor([[self.t1 - 4], [self.t1 - 2]], device=v.device)
        d = float(gdist.frame_distance(v.poses, v.disps, v.intrinsics[0],
                                       pair[0], pair[1], self.beta)[0])
        if d >= 2 * self.keyframe_thresh:
            g.update(None, None, use_inactive=True, n_iters=self.iters2)
            self._init_next_state()
        self._pending_kf = d

    def finalize(self, kf_value=None):
        """Apply the previous update's keyframe decision: drop a redundant
        keyframe and re-predict the incoming frame. ``kf_value``: the
        distance the frame program read back; on the frame path a kept
        keyframe ages by the ``iters2`` iterations that ran on the
        device."""
        if kf_value is None:
            if self._pending_kf is None:
                return
            kf_value, self._pending_kf = float(self._pending_kf), None
        if kf_value < 2 * self.keyframe_thresh:
            with self.video.get_lock():
                self.graph.rm_keyframe(self.t1 - 3)
                self.video.counter -= 1
            self.t1 -= 1
            self._init_next_state()
        elif isinstance(self.graph, SlotGraph):
            self.graph.bump_age(self.iters2)

    def _initialize(self):
        self.t1 = self.video.counter
        g = self.graph
        g.add_neighborhood_factors(0, self.t1, r=3)
        g.update(1, use_inactive=True, n_iters=8)
        g.add_proximity_factors(0, 0, rad=2, nms=2,
                                thresh=self.frontend_thresh, remove=False)
        g.update(1, use_inactive=True, n_iters=8)
        self.is_initialized = True
        with self.video.get_lock():
            self.video.ready = True
            self.video.dirty[:self.t1] = True
        g.rm_factors(g.ii < self.warmup - 4, store=True)

    def __call__(self):
        if not self.is_initialized and self.video.counter == self.warmup:
            self._initialize()
            self._init_next_state()
        elif self.is_initialized and self.t1 < self.video.counter:
            self._update()
