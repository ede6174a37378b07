"""Wrappers of the CUDA ConvGRU gate epilogues (``csrc/gru_epilogue.cu``).

``gru_epilogue_a`` and ``gru_epilogue_b`` take the NCHW tensors of
``ops/gru.py``'s plain twins. A CUDA tensor goes to the kernel (each launch
counted in ``LAUNCHES_A`` / ``LAUNCHES_B``), launched on the operands' own
device whatever device is current; a CPU tensor goes to the twin.
"""

from __future__ import annotations

import torch

from . import _build
from .gru import gru_epilogue_a_plain, gru_epilogue_b_plain

LAUNCHES_A = 0  # kernel launches since the counts were last reset
LAUNCHES_B = 0
_C = 128


def _check(cond, msg):
    if not cond:
        raise ValueError(f"gru epilogue: {msg}")


def _validate(planes, gate, gate_ch):
    """planes: (name, tensor, channels) of [E,C,h,w] operands; gate [E,C].
    Returns (E, h*w, vec8)."""
    net = planes[0][1]
    dev, dtype = net.device, net.dtype
    _check(dtype in (torch.bfloat16, torch.float32), f"dtype {dtype}")
    _check(net.dim() == 4, f"net must be [E,128,h,w], got {tuple(net.shape)}")
    E, _, h, w = net.shape
    for name, t, ch in planes:
        _check(t.device == dev and t.dtype == dtype,
               f"{name} must be {dtype} on {dev}")
        _check(t.is_contiguous() and tuple(t.shape) == (E, ch, h, w),
               f"{name} must be contiguous [{E},{ch},{h},{w}], got "
               f"{tuple(t.shape)}")
    _check(gate.device == dev and gate.dtype == dtype
           and gate.is_contiguous() and tuple(gate.shape) == (E, gate_ch),
           f"gate bias must be contiguous {dtype} [{E},{gate_ch}]")
    _check(dev.type == "cuda", f"unsupported device {dev}")
    vec8 = (h * w) % 8 == 0 and all(t.data_ptr() % 16 == 0
                                    for _, t, _ in planes)
    return E, h * w, vec8


def _raise_on(err, which):
    if err != 0:
        raise RuntimeError(f"gru epilogue {which} kernel launch failed: "
                           f"cudaError {err}")


def gru_epilogue_a(zrc, cf, pre_zr, net, gzr):
    """(z, r*net) [E,128,h,w]; see ops/gru.py::gru_epilogue_a_plain."""
    global LAUNCHES_A
    if net.device.type == "cpu":
        return gru_epilogue_a_plain(zrc, cf, pre_zr, net, gzr)
    E, HW, vec8 = _validate([("net", net, _C), ("zrc", zrc, 2 * _C),
                             ("cf", cf, 3 * _C), ("pre_zr", pre_zr, 2 * _C)],
                            gzr, 2 * _C)
    z, rnet = (torch.empty(net.shape, dtype=net.dtype, device=net.device)
               for _ in range(2))
    if E == 0:
        return z, rnet
    with torch.cuda.device(net.device):
        _raise_on(_build.lib().droid_gru_epilogue_a(
            int(net.dtype == torch.bfloat16), int(vec8), E, HW,
            zrc.data_ptr(), cf.data_ptr(), pre_zr.data_ptr(), net.data_ptr(),
            gzr.data_ptr(), z.data_ptr(), rnet.data_ptr(),
            torch.cuda.current_stream(net.device).cuda_stream), "A")
    LAUNCHES_A += 1
    return z, rnet


def gru_epilogue_b(qc, cf, pre_q, net, z, gq):
    """New hidden state [E,128,h,w]; see ops/gru.py::gru_epilogue_b_plain."""
    global LAUNCHES_B
    if net.device.type == "cpu":
        return gru_epilogue_b_plain(qc, cf, pre_q, net, z, gq)
    E, HW, vec8 = _validate([("net", net, _C), ("qc", qc, _C),
                             ("cf", cf, 3 * _C), ("pre_q", pre_q, _C),
                             ("z", z, _C)], gq, _C)
    out = torch.empty(net.shape, dtype=net.dtype, device=net.device)
    if E == 0:
        return out
    with torch.cuda.device(net.device):
        _raise_on(_build.lib().droid_gru_epilogue_b(
            int(net.dtype == torch.bfloat16), int(vec8), E, HW,
            qc.data_ptr(), cf.data_ptr(), pre_q.data_ptr(), net.data_ptr(),
            z.data_ptr(), gq.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(net.device).cuda_stream), "B")
    LAUNCHES_B += 1
    return out
