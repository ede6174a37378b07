"""EuRoC evaluation with the PyTorch/CUDA port: track at stride 2, fill the
poses at stride 1, and print the Sim3-aligned ATE against the TUM-format
ground truth with the 1.10 position scale factor.

The flags and output of ``test_euroc.py``, plus ``--device`` (the card
unless ``--device cpu``):

    python evaluation_scripts/test_euroc_torch.py --datapath MH_01 \
        --gt data/euroc_groundtruth/MH_01_easy.txt \
        --weights checkpoints/r5_006000.npz [--stereo]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from droid_slam_tpu_torch.config import (  # noqa: E402
    EUROC_SCALE_FACTOR, PRESETS)
from droid_slam_tpu_torch.data.stream import (  # noqa: E402
    euroc_stream, euroc_timestamps)
from droid_slam_tpu_torch.eval.ate import evaluate_ate  # noqa: E402
from droid_slam_tpu_torch.slam import make_droid  # noqa: E402
from droid_slam_tpu_torch.utils.device import require_device  # noqa: E402


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--datapath", required=True)
    parser.add_argument("--gt", required=True)
    parser.add_argument("--weights", default=None)
    parser.add_argument("--asynchronous", action="store_true")
    parser.add_argument("--stereo", action="store_true")
    parser.add_argument("--backend_steps", type=int, nargs="+",
                        default=[7, 12])
    # overrides for reduced-resolution or fixture runs (the defaults are
    # the tuned EuRoC hyperparameters of PRESETS["euroc"])
    parser.add_argument("--image_size", type=int, nargs=2, default=None)
    parser.add_argument("--buffer", type=int, default=None)
    parser.add_argument("--warmup", type=int, default=None)
    parser.add_argument("--filter_thresh", type=float, default=None)
    parser.add_argument("--keyframe_thresh", type=float, default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    require_device("test_euroc_torch.py", args.device)

    import dataclasses
    cfg = dataclasses.replace(PRESETS["euroc"], stereo=args.stereo,
                              weights=args.weights,
                              asynchronous=args.asynchronous)
    overrides = {k: getattr(args, k) for k in
                 ("buffer", "warmup", "filter_thresh", "keyframe_thresh")
                 if getattr(args, k) is not None}
    if args.image_size is not None:
        overrides["image_size"] = tuple(args.image_size)
    cfg = dataclasses.replace(cfg, **overrides)
    droid = make_droid(cfg, device=args.device)

    images = euroc_stream(args.datapath, stereo=args.stereo, stride=1,
                          image_size=cfg.image_size)
    for (t, image, intrinsics) in images[::2]:  # track at stride 2
        droid.track(t, image, intrinsics=intrinsics)

    traj_est = droid.terminate(iter(images),
                               backend_steps=tuple(args.backend_steps))

    # ground truth: "#timestamp [ns] x y z qw qx qy qz"
    tstamps = euroc_timestamps(args.datapath)
    gt = np.loadtxt(args.gt, delimiter=" ", skiprows=1)
    t_ref = gt[:, 0] / 1e9 if gt[0, 0] > 1e14 else gt[:, 0]
    result = evaluate_ate(EUROC_SCALE_FACTOR * traj_est[:, :3], gt[:, 1:4],
                          t_est=tstamps[:len(traj_est)] / 1e9,
                          t_ref=t_ref, scale=True, max_dt=0.1)
    print(f"ATE RMSE: {result['ate_rmse']:.4f} m "
          f"(scale {result['scale']:.3f}, {result['n_matches']} matches)")


if __name__ == "__main__":
    main()
