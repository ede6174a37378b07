"""CUDA graph captures of the frame programs inside the window
(``FramePrograms.captures``): each is an eager warm-up run and two
captures, a tail of ``track()`` calls."""

LAYER = "frame programs (slam/fused_frame.py)"
UNIT = "count"
MOVES = "track_call_ms_p95"


def read(ctx):
    return ctx["window"]["captures"]
