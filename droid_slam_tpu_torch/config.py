"""Configuration of the tracking path (``track()`` and ``terminate()``), with
the field names, defaults and per-dataset presets of
``droid_slam_tpu/config.py``."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class DroidConfig:
    # capacity / resolution / input
    buffer: int = 512
    image_size: Tuple[int, int] = (240, 320)
    # each frame is a rectified [2,H,W,3] stack, left then right
    stereo: bool = False
    # the caller passes a depth map per frame (RGB-D); recorded for the
    # callers, as in JAX: tracking takes the depth map whenever it is given
    depth: bool = False
    # convex upsampling of the disparities to full resolution (disps_up)
    upsample: bool = False

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

    # edge-parallel frontend (parallel/frontend.py): the update operator's
    # edges in contiguous blocks over this many devices, cuda:0..N-1 unless
    # the tracker is given its devices (0 = serial)
    edge_parallel: int = 0

    # the ConvGRU's gate epilogues as two fused kernels (csrc/gru_epilogue.cu)
    # in the frontend's and the trajectory filler's updates: the port's
    # counterpart of DROID_GRU_PALLAS=1, off by default as in JAX
    gru_fused_epilogue: bool = False

    # the tracker's steady-state frame as two programs (slam/fused_frame.py;
    # on CUDA each is a replay of a captured CUDA graph), and their
    # speculative dispatch ahead of the previous frame's readback: the
    # port's DROID_FUSED_FRAME and DROID_SPEC_FRAME. fused_frame None takes
    # JAX's rule: on when the tracker runs on CUDA, off on the CPU.
    # spec_frame None is off (JAX turns it on with the frame programs; on
    # the card the synthetic evaluation collapsed with it, ROADMAP.md §3
    # item 16); speculation only with the frame programs; edge_parallel
    # turns both off (slam/droid.py::frame_path)
    fused_frame: Optional[bool] = None
    spec_frame: Optional[bool] = None

    # weights: a ``.npz`` of the JAX package's parameters, a reference-format
    # ``.pth`` state_dict, or None for a seeded random initialization
    weights: Optional[str] = None

    # the global BA runs beside tracking (slam/async_droid.py, or with
    # DROID_ASYNC_PROCESS=1 slam/async_process.py); make_droid selects it
    asynchronous: bool = False

    # visualisation and io: ``Droid`` starts the live viewer
    # (eval/viewer.py::launch_viewer) in a daemon thread when enable_vis is
    # set; t0, stride and reconstruction_path are the stream options of the
    # command lines, recorded with the configuration as in JAX
    enable_vis: bool = False
    t0: int = 0
    stride: int = 1
    reconstruction_path: Optional[str] = None


# per-dataset tuned defaults: the reference's evaluation scripts' argparse
# defaults (droid_slam_tpu/config.py:52-85)
PRESETS = {
    "demo": DroidConfig(),
    "tartanair": DroidConfig(
        buffer=1000, image_size=(384, 512), beta=0.3, filter_thresh=2.5,
        warmup=12, keyframe_thresh=3.0, frontend_thresh=15.0,
        frontend_window=20, frontend_radius=1, frontend_nms=1,
        backend_thresh=20.0, backend_radius=2, backend_nms=3,
        motion_damping=0.5),
    "euroc": DroidConfig(
        buffer=512, image_size=(320, 512), beta=0.3, filter_thresh=2.4,
        warmup=15, keyframe_thresh=3.0, frontend_thresh=17.5,
        frontend_window=20, frontend_radius=2, frontend_nms=1,
        backend_thresh=24.0, backend_radius=2, backend_nms=2),
    "tum": DroidConfig(
        buffer=512, image_size=(240, 320), beta=0.3, filter_thresh=1.5,
        warmup=12, keyframe_thresh=2.0, frontend_thresh=12.0,
        frontend_window=25, frontend_radius=2, frontend_nms=1,
        backend_thresh=20.0, backend_radius=2, backend_nms=3,
        motion_damping=0.5),
    # eth3d: the evaluation resizes every sequence to about sqrt(384*512)
    # area and overrides image_size per sequence
    "eth3d": DroidConfig(
        buffer=1024, beta=0.5, filter_thresh=2.0, warmup=8,
        keyframe_thresh=3.5, frontend_thresh=16.0, frontend_window=20,
        frontend_radius=2, frontend_nms=1, backend_thresh=22.0,
        backend_radius=2, backend_nms=3, motion_damping=0.5),
}

STEREO_SCALE_FACTOR = 2.5  # TartanAir stereo trajectories' scale
EUROC_SCALE_FACTOR = 1.10  # EuRoC stereo trajectories' scale
