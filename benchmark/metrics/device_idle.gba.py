"""The share of the traced window of global-BA passes in which no operation
ran on the device: 1 - (union of the device operations' intervals) /
window."""

LAYER = "device (H100)"
UNIT = "%"
MOVES = "gba_s_per_step"


def read(ctx):
    tl = ctx["timeline"]
    if tl is None or tl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
