"""Wrapper of the CUDA on-the-fly correlation kernel (``csrc/alt_corr.cu``).

``alt_lookup`` computes the global BA's correlation windows from the feature
pyramid, as ``ops/corr.py::alt_lookup`` does. A CUDA tensor goes to the
kernel (one launch for all levels, counted in ``LAUNCHES``), launched on the
operands' own device whatever device is current; a CPU tensor goes to the
plain twin, ``ops/corr.py::alt_lookup``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import corr

LAUNCHES = 0  # kernel launches since the count was last reset

CHANNELS = 128


def _check(cond, msg):
    if not cond:
        raise ValueError(f"alt correlation: {msg}")


def alt_lookup(fmap_pyramid, coords, ii, jj, radius: int = corr.RADIUS):
    """fmap_pyramid: ``corr.build_fmap_pyramid``'s levels, [N,h_l,w_l,128]
    bf16 channels last; coords [E,HW,2] f32 at level-0 scale; ii, jj [E]
    int32 or int64 source and target rows of the pyramid (view-flattened
    in stereo). Returns [E,HW,L*(2r+1)^2] f32, level-major channels."""
    if coords.device.type == "cpu":
        return corr.alt_lookup(fmap_pyramid, coords, ii, jj, radius)
    return _launch(fmap_pyramid, coords, ii, jj, radius)


def _launch(pyramid, coords, ii, jj, radius):
    """The kernel's launch. Shapes, types and layouts are checked first,
    then the devices, so that a tensor on ``meta`` shows each check."""
    global LAUNCHES
    L = len(pyramid)
    _check(radius == corr.RADIUS,
           f"the kernel is built for radius {corr.RADIUS}")
    _check(1 <= L <= 4, f"1..4 levels, got {L}")
    _check(coords.dtype == torch.float32 and coords.is_contiguous()
           and coords.dim() == 3 and coords.shape[2] == 2,
           "coords must be contiguous f32 [E,HW,2]")
    E, HW = coords.shape[:2]
    _check(ii.dtype == jj.dtype and ii.dtype in (torch.int32, torch.int64)
           and ii.is_contiguous() and jj.is_contiguous()
           and ii.shape == (E,) and jj.shape == (E,),
           "ii and jj must be contiguous int32 or int64 [E] of one dtype")
    N = pyramid[0].shape[0]
    for f in pyramid:
        _check(f.dtype == torch.bfloat16 and f.is_contiguous()
               and f.dim() == 4 and f.shape[0] == N
               and f.shape[3] == CHANNELS,
               f"levels must be contiguous bf16 [N,h,w,{CHANNELS}]")
    _check(pyramid[0].shape[1] * pyramid[0].shape[2] == HW,
           "coords' pixels must be level 0's")
    dev = coords.device
    _check(dev.type == "cuda", f"unsupported device {dev}")
    _check(all(t.device == dev for t in (ii, jj, *pyramid)),
           "every operand must lie on the coords' device")
    _check(coords.data_ptr() % 8 == 0, "coords must be 8-byte aligned")
    _check(all(f.data_ptr() % 16 == 0 for f in pyramid),
           "levels must be 16-byte aligned")
    out = torch.empty((E, HW, L * (2 * radius + 1) ** 2),
                      dtype=torch.float32, device=dev)
    if E == 0:
        return out
    ptrs = [f.data_ptr() for f in pyramid] + [0] * (4 - L)
    h = (ctypes.c_int * 4)(*[f.shape[1] for f in pyramid], *[0] * (4 - L))
    w = (ctypes.c_int * 4)(*[f.shape[2] for f in pyramid], *[0] * (4 - L))
    # the launch goes to the current device: make it the operands' own
    with torch.cuda.device(dev):
        err = _build.lib().droid_alt_corr(
            L, *ptrs, ctypes.addressof(h), ctypes.addressof(w), N, E, HW,
            coords.data_ptr(), ii.data_ptr(), jj.data_ptr(),
            int(ii.dtype == torch.int64), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"alt correlation kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return out
