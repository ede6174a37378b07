"""Milliseconds of the traced window in which the device was busy, per
tracked frame."""

LAYER = "device (H100)"
UNIT = "ms"
MOVES = "track_fps"


def read(ctx):
    tl = ctx["timeline"]
    if tl is None or tl.busy_s <= 0 or not ctx["frames"]:
        return None
    return 1e3 * tl.busy_s / ctx["frames"]
