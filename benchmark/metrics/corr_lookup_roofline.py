"""The correlation lookup kernel's share of its roofline: the least time its
launches in the traced window could take, the bytes of the live edges'
windows and outputs (``benchmark/bytes.py``) over the published HBM rate,
divided by the device time of the kernel (``corr_lookup_kernel``, launches
inside graph replays included). Per frame the admission lookup on one edge
and, per kept iteration of an update, the lookup over the live edges."""

from benchmark import bytes as nbytes, peaks

LAYER = "kernels (ops/corr_cuda.py, csrc/corr_lookup.cu)"
UNIT = "%"
MOVES = "track_fps"
KERNEL = "corr_lookup_kernel"


def read(ctx):
    tl = ctx["timeline"]
    bw = peaks.get(ctx["device"]["kind"], "hbm_bytes_per_s")
    if tl is None or bw is None:
        return None
    t = sum(s for n, s in tl.time_by_name().items() if KERNEL in n)
    if t <= 0:
        return None
    H, W = ctx["image_size"]
    h, w = H // 8, W // 8
    per_edge = nbytes.lookup(1, h, w)
    n = ctx["frames"]
    for c in ctx["updates"]:
        n += (c["iters1"] + (c["iters2"] if c["keep"] else 0)) * c["edges"]
    return 100.0 * n * per_edge / bw / t
