"""The share of the window's frames that the motion filter admitted as
keyframes, from the admission deltas the tracker read back (a delta above
its threshold admits the frame); keyframes removed later still count."""

LAYER = "admission (slam/motion_filter.py)"
UNIT = "%"
MOVES = "track_fps"


def read(ctx):
    w = ctx["window"]
    return 100.0 * w["admitted"] / w["frames"] if w["frames"] else None
