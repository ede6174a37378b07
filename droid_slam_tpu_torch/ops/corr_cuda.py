"""Wrapper of the CUDA corr-window lookup kernel (``csrc/corr_lookup.cu``).

``lookup_pyramid_slots`` samples every pyramid level for each active edge
through a slot table, as ``droid_slam_tpu/ops/corr_pallas.py::
lookup_pyramid_slots`` does. A CUDA tensor goes to the kernel (one launch for
all levels, counted in ``LAUNCHES``), launched on the operands' own device
whatever device is current; a CPU tensor goes to the plain twin,
``ops/corr.py::lookup_pyramid_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .corr import RADIUS, lookup_pyramid_plain

LAUNCHES = 0  # kernel launches since the count was last reset


def _check(cond, msg):
    if not cond:
        raise ValueError(f"corr lookup: {msg}")


def lookup_pyramid_slots(pyramid, slots, coords, radius: int = RADIUS):
    """pyramid: list of [EB,HW,h2_l,w2_l] volumes (bf16 or f32);
    slots [EA] int32 (edge a reads volume slots[a]); coords [EA,HW,2] f32 at
    level-0 scale. Returns [EA,HW,L*(2r+1)^2] f32, level-major channels."""
    if coords.device.type == "cpu":
        return lookup_pyramid_plain(pyramid, slots, coords, radius)
    return _launch(pyramid, slots, coords, radius)


def _launch(pyramid, slots, coords, radius):
    global LAUNCHES
    dev = coords.device
    L = len(pyramid)
    _check(dev.type == "cuda", f"unsupported device {dev}")
    _check(radius == RADIUS, f"the kernel is built for radius {RADIUS}")
    _check(1 <= L <= 4, f"1..4 levels, got {L}")
    _check(coords.dtype == torch.float32 and coords.is_contiguous()
           and coords.dim() == 3 and coords.shape[2] == 2,
           "coords must be contiguous f32 [EA,HW,2]")
    _check(coords.data_ptr() % 8 == 0, "coords must be 8-byte aligned")
    EA, HW = coords.shape[:2]
    _check(slots.device == dev and slots.dtype == torch.int32
           and slots.is_contiguous() and slots.shape == (EA,),
           "slots must be contiguous int32 [EA] on the coords' device")
    dtype = pyramid[0].dtype
    _check(dtype in (torch.bfloat16, torch.float32), f"volume dtype {dtype}")
    EB = pyramid[0].shape[0]
    for v in pyramid:
        _check(v.device == dev and v.dtype == dtype and v.is_contiguous()
               and v.dim() == 4 and v.shape[:2] == (EB, HW),
               "volumes must be contiguous [EB,HW,h2,w2] of one dtype")
    out = torch.empty((EA, HW, L * (2 * radius + 1) ** 2),
                      dtype=torch.float32, device=dev)
    if EA == 0:
        return out
    ptrs = [v.data_ptr() for v in pyramid] + [0] * (4 - L)
    h2 = (ctypes.c_int * 4)(*[v.shape[2] for v in pyramid], *[0] * (4 - L))
    w2 = (ctypes.c_int * 4)(*[v.shape[3] for v in pyramid], *[0] * (4 - L))
    # the launch goes to the current device: make it the operands' own
    with torch.cuda.device(dev):
        err = _build.lib().droid_corr_lookup(
            L, *ptrs, ctypes.addressof(h2), ctypes.addressof(w2),
            int(dtype == torch.bfloat16), EA, EB, HW, coords.data_ptr(),
            slots.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"corr lookup kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return out
