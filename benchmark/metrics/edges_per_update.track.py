"""The mean number of live edges of the frontend's graph at each update in
the window, read from the graph as each frame program is dispatched."""

LAYER = "frontend (slam/frontend.py, state/graph.py)"
UNIT = "count"
MOVES = "track_fps"


def read(ctx):
    upd = ctx["window"]["updates"]
    return sum(c["edges"] for c in upd) / len(upd) if upd else None
