"""The mean number of live stereo (i, i) edges of the frontend's graph at
each update in the window: the tracker's ``update_stereo_edges`` counter's
change over the window, over the updates the probe saw. None where the
tracker has no such counter."""

LAYER = ("frontend stereo edges (state/graph.py::add_proximity_factors, "
         "slam/droid.py)")
UNIT = "count"
MOVES = "track_fps"


def read(ctx):
    w = ctx["window"]
    n = w.get("update_stereo_edges")
    return n / len(w["updates"]) if n is not None and w["updates"] else None
