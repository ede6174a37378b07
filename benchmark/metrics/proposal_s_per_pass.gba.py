"""Seconds per pass in the proximity proposal over all keyframe pairs
(``FactorGraph.add_proximity_factors``: ``DepthVideo.distance``, the
suppression walk on the host and the new edges), timed between device
synchronisations."""

LAYER = ("proposal (state/graph.py::add_proximity_factors, "
         "state/video.py::distance)")
UNIT = "s"
MOVES = "gba_s_per_step"


def read(ctx):
    sp = ctx["spans"]
    return sp["proposal"] / ctx["passes"] if sp["proposal"] else None
