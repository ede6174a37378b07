"""DroidBackend: global bundle adjustment over all keyframes.

Counterpart of ``droid_slam_tpu/slam/backend.py::DroidBackend``: normalize
the scale (mean disparity 1) unless a stereo rig or a depth sensor fixes it,
build a fresh factor graph with on-the-fly correlation and room for 16 edges
per keyframe, propose proximity edges over all keyframes, run the chunked
global BA (``FactorGraph.update_lowmem``, which also upsamples with
``upsample``), and drop the graph.
"""

from __future__ import annotations

from ..state.graph import FactorGraph


class DroidBackend:
    def __init__(self, params, video, cfg):
        self.video = video
        self.params = params
        self.beta = cfg.beta
        self.backend_thresh = cfg.backend_thresh
        self.backend_radius = cfg.backend_radius
        self.backend_nms = cfg.backend_nms
        self.upsample = cfg.upsample

    def __call__(self, steps=12):
        """One global-BA pass of ``steps`` steps; returns its edge count."""
        v = self.video
        t = v.counter
        if not v.stereo and not bool(v.disps_sens.any()):
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
