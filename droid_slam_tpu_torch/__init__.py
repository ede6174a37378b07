"""PyTorch/CUDA port of droid_slam_tpu for one NVIDIA Hopper GPU.

The package mirrors the JAX package's layout (``lie/se3.py``,
``geom/projective.py``, ``state/graph.py``, ...) so that each module's
counterpart is easy to find. It runs the monocular synchronous tracking path:

    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.slam.droid import Droid

    droid = Droid(DroidConfig(image_size=(320, 512), weights=...))
    for t, image, intrinsics in stream:
        droid.track(t, image, intrinsics=intrinsics)
    droid.flush()

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``. On a
CUDA tensor the corr-window lookup launches the hand-written kernel in
``csrc/corr_lookup.cu``; on a CPU tensor it runs the plain PyTorch twin.
Importing the package builds nothing and imports no JAX.
"""
