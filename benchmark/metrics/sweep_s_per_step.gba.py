"""Seconds per global-BA step in the sweep of the update operator over every
edge with on-the-fly correlation: ``FactorGraph.update_lowmem`` less
``DepthVideo.ba``, each timed between device synchronisations."""

LAYER = "global BA (slam/backend.py, state/graph.py::update_lowmem)"
UNIT = "s"
MOVES = "gba_s_per_step"


def read(ctx):
    sp = ctx["spans"]
    if not sp["sweep_ba"]:
        return None
    return (sp["sweep_ba"] - sp["ba"]) / ctx["steps"]
