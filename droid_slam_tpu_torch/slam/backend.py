"""Global bundle adjustment over all keyframes.

Counterpart of ``droid_slam_tpu/slam/backend.py``. ``DroidBackend``:
normalize the scale (mean disparity 1, unless the caller asks not to, or a
stereo rig or a depth sensor fixes it), build a fresh factor graph with
on-the-fly correlation and room for 16 edges per keyframe, propose
proximity edges over all keyframes, run the chunked global BA
(``FactorGraph.update_lowmem``, which also upsamples with ``upsample``),
and drop the graph. ``DroidAsyncBackend``, the
asynchronous facades' backend, keeps one graph with no edge cap across its
calls: each call proposes proximity edges over the keyframes it has now,
runs the global BA with the inactive edges too, and retires the edges older
than ``max_age`` updates to the inactive set. A pass of either is the span
``droid:gba_pass``.
"""

from __future__ import annotations

from ..state.graph import FactorGraph
from ..utils import trace


class DroidBackend:
    def __init__(self, params, video, cfg):
        self.video = video
        self.params = params
        self.beta = cfg.beta
        self.backend_thresh = cfg.backend_thresh
        self.backend_radius = cfg.backend_radius
        self.backend_nms = cfg.backend_nms
        self.upsample = cfg.upsample

    def __call__(self, steps=12, normalize=True):
        """One global-BA pass of ``steps`` steps, first rescaling the mean
        disparity to 1 when ``normalize``; returns its edge count."""
        with trace.span("gba_pass"):
            v = self.video
            t = v.counter
            if normalize and not v.stereo and not bool(v.disps_sens.any()):
                v.normalize()
            graph = FactorGraph(v, self.params, max_factors=16 * t,
                                corr_impl="alt", upsample=self.upsample)
            graph.add_proximity_factors(rad=self.backend_radius,
                                        nms=self.backend_nms,
                                        thresh=self.backend_thresh,
                                        beta=self.beta)
            edges = len(graph.ii)
            if edges:
                graph.update_lowmem(steps=steps)
                graph.clear_edges()
            return edges


class DroidAsyncBackend:
    def __init__(self, params, video, cfg, max_age=7):
        self.video = video
        self.max_age = max_age
        self.beta = cfg.beta
        self.backend_thresh = cfg.backend_thresh
        self.backend_radius = cfg.backend_radius
        self.backend_nms = cfg.backend_nms
        self.graph = FactorGraph(video, params, max_factors=-1,
                                 corr_impl="alt", upsample=cfg.upsample)

    def __call__(self, steps=12, normalize=True):
        """One global-BA pass of ``steps`` steps over the persistent graph;
        returns its active edge count."""
        with trace.span("gba_pass"):
            v, g = self.video, self.graph
            if normalize and not v.stereo and not bool(v.disps_sens.any()):
                v.normalize()
            g.add_proximity_factors(rad=self.backend_radius,
                                    nms=self.backend_nms,
                                    thresh=self.backend_thresh,
                                    beta=self.beta)
            edges = len(g.ii)
            if edges:
                g.update_lowmem(steps=steps, use_inactive=True)
                g.rm_factors(g.age > self.max_age, store=True)
            return edges
