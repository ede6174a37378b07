"""Configuration of the monocular path (tracking and ``terminate()``), with
the field names and defaults of ``droid_slam_tpu/config.py``."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class DroidConfig:
    # capacity / resolution
    buffer: int = 512
    image_size: Tuple[int, int] = (240, 320)

    # motion filter
    filter_thresh: float = 2.4

    # frontend
    beta: float = 0.3
    warmup: int = 8
    keyframe_thresh: float = 4.0
    frontend_thresh: float = 16.0
    frontend_window: int = 25
    frontend_radius: int = 2
    frontend_nms: int = 1
    motion_damping: float = 0.0

    # backend (global BA in terminate())
    backend_thresh: float = 22.0
    backend_radius: int = 2
    backend_nms: int = 3

    # the ConvGRU's gate epilogues as two fused kernels (csrc/gru_epilogue.cu)
    # in the frontend's and the trajectory filler's updates: the port's
    # counterpart of DROID_GRU_PALLAS=1, off by default as in JAX
    gru_fused_epilogue: bool = False

    # weights: a ``.npz`` of the JAX package's parameters, or None for a
    # seeded random initialization
    weights: Optional[str] = None


PRESETS = {
    "euroc": DroidConfig(
        buffer=512, image_size=(320, 512), beta=0.3, filter_thresh=2.4,
        warmup=15, keyframe_thresh=3.0, frontend_thresh=17.5,
        frontend_window=20, frontend_radius=2, frontend_nms=1,
        backend_thresh=24.0, backend_radius=2, backend_nms=2),
}
