"""Milliseconds per global-BA step in the bundle adjustment's Gauss-Newton
iterations (``DepthVideo.ba``), timed between device synchronisations."""

LAYER = "BA (ba/inference.py)"
UNIT = "ms"
MOVES = "gba_s_per_step"


def read(ctx):
    sp = ctx["spans"]
    return 1e3 * sp["ba"] / ctx["steps"] if sp["ba"] else None
