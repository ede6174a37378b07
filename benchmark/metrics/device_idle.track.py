"""The share of the traced tracking window in which no operation ran on the
device: 1 - (union of the device operations' intervals) / window."""

LAYER = "device (H100)"
UNIT = "%"
MOVES = "track_fps"


def read(ctx):
    tl = ctx["timeline"]
    if tl is None or tl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
