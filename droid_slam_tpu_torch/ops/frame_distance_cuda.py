"""Wrapper of the CUDA frame-distance kernel (``csrc/frame_distance.cu``).

``frame_distance`` computes the flow-magnitude distance of each pair of
frames, as ``geom/distance.py::frame_distance`` does. A CUDA tensor goes to
the kernel (one launch for all pairs, counted in ``LAUNCHES``), launched on
the operands' own device whatever device is current; a CPU tensor goes to
the plain twin, ``geom/distance.py::frame_distance``.
"""

from __future__ import annotations

import torch

from . import _build
from ..geom import distance as gdist

LAUNCHES = 0  # kernel launches since the count was last reset


def _check(cond, msg):
    if not cond:
        raise ValueError(f"frame distance: {msg}")


def frame_distance(poses, disps, intrinsics, ii, jj, beta=0.3,
                   bidirectional=True):
    """Distance of each pair (ii[k], jj[k]) -> [len(ii)] f32. poses [N,7]
    f32, disps [N,h,w] f32, intrinsics one [4] f32 vector, ii and jj [E]
    int32 or int64 rows."""
    if disps.device.type == "cpu":
        return gdist.frame_distance(poses, disps, intrinsics, ii, jj, beta,
                                    bidirectional=bidirectional)
    return _launch(poses, disps, intrinsics, ii, jj, beta, bidirectional)


def _launch(poses, disps, intrinsics, ii, jj, beta, bidirectional):
    """The kernel's launch. Shapes, types and layouts are checked first,
    then the devices, so that a tensor on ``meta`` shows each check."""
    global LAUNCHES
    _check(poses.dtype == torch.float32 and poses.is_contiguous()
           and poses.dim() == 2 and poses.shape[1] == 7,
           "poses must be contiguous f32 [N,7]")
    N = poses.shape[0]
    _check(disps.dtype == torch.float32 and disps.is_contiguous()
           and disps.dim() == 3 and disps.shape[0] == N,
           "disps must be contiguous f32 [N,h,w] with the poses' N")
    h, w = disps.shape[1:]
    _check(0 < h * w < 2 ** 24, f"{h}x{w} pixels: the counts need < 2^24")
    _check(intrinsics.dtype == torch.float32 and intrinsics.shape == (4,)
           and intrinsics.is_contiguous(),
           "intrinsics must be one contiguous f32 [4] vector")
    _check(ii.dtype == jj.dtype and ii.dtype in (torch.int32, torch.int64)
           and ii.is_contiguous() and jj.is_contiguous()
           and ii.dim() == 1 and ii.shape == jj.shape,
           "ii and jj must be contiguous int32 or int64 [E] of one dtype")
    dev = disps.device
    _check(dev.type == "cuda", f"unsupported device {dev}")
    _check(all(t.device == dev for t in (poses, intrinsics, ii, jj)),
           "every operand must lie on the disparities' device")
    E = ii.shape[0]
    out = torch.empty((E,), dtype=torch.float32, device=dev)
    if E == 0:
        return out
    # the launch goes to the current device: make it the operands' own
    with torch.cuda.device(dev):
        err = _build.lib().droid_frame_distance(
            poses.data_ptr(), disps.data_ptr(), intrinsics.data_ptr(), N, h,
            w, ii.data_ptr(), jj.data_ptr(), int(ii.dtype == torch.int64), E,
            float(beta), 1.0 - float(beta), int(bool(bidirectional)),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"frame distance kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return out
