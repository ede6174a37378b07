"""PyTorch/CUDA port of droid_slam_tpu for one NVIDIA Hopper GPU.

The package mirrors the JAX package's layout (``lie/se3.py``,
``geom/projective.py``, ``state/graph.py``, ...) so that each module's
counterpart is easy to find. It runs the synchronous tracking path for
monocular, stereo (``stereo=True``: [2,H,W,3] stacks) and RGB-D input (a
depth map per frame), with optional full-resolution disparities
(``upsample=True``):

    from droid_slam_tpu_torch.config import PRESETS
    from droid_slam_tpu_torch.slam.droid import Droid

    droid = Droid(dataclasses.replace(PRESETS["tum"], weights=...))
    for t, image, depth, intrinsics in stream:
        droid.track(t, image, depth, intrinsics)
    poses = droid.terminate(stream_of_all_frames)

``slam.make_droid(cfg)`` picks the facade: ``Droid``, or with
``cfg.asynchronous`` ``DroidAsync`` (the global BA in a thread beside
tracking) or, with ``DROID_ASYNC_PROCESS=1``, ``DroidAsyncProcess`` (the
global BA in a process of its own). ``demo_torch.py`` is the command line.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``. On
CUDA tensors the corr-window lookup and the GRU's fused epilogues launch
the hand-written kernels of ``csrc/``; on CPU tensors their plain PyTorch
twins run. Importing the package builds nothing and imports no JAX.
"""
