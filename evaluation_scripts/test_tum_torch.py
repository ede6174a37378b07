"""TUM-RGBD monocular evaluation with the PyTorch/CUDA port: stride-2
tracking, and the ATE with a Sim3 alignment against groundtruth.txt.

The flags and output of ``test_tum.py``, plus ``--device`` (the card unless
``--device cpu``):

    python evaluation_scripts/test_tum_torch.py \
        --datapath rgbd_dataset_freiburg1_360 \
        --weights checkpoints/r5_006000.npz
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from droid_slam_tpu_torch.config import PRESETS  # noqa: E402
from droid_slam_tpu_torch.data.stream import (  # noqa: E402
    tum_stream, tum_timestamps)
from droid_slam_tpu_torch.eval.ate import evaluate_ate  # noqa: E402
from droid_slam_tpu_torch.slam import make_droid  # noqa: E402
from droid_slam_tpu_torch.utils.device import require_device  # noqa: E402


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--datapath", required=True)
    parser.add_argument("--weights", default=None)
    parser.add_argument("--asynchronous", action="store_true")
    parser.add_argument("--backend_steps", type=int, nargs="+",
                        default=[7, 12])
    # overrides for reduced-resolution or fixture runs (the defaults are
    # the tuned TUM hyperparameters of PRESETS["tum"])
    parser.add_argument("--image_size", type=int, nargs=2, default=None)
    parser.add_argument("--buffer", type=int, default=None)
    parser.add_argument("--warmup", type=int, default=None)
    parser.add_argument("--filter_thresh", type=float, default=None)
    parser.add_argument("--keyframe_thresh", type=float, default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser


def _has_header(path):
    with open(path) as f:
        return f.readline().startswith("#")


def main(argv=None):
    args = build_parser().parse_args(argv)
    require_device("test_tum_torch.py", args.device)

    import dataclasses
    cfg = dataclasses.replace(PRESETS["tum"], weights=args.weights,
                              asynchronous=args.asynchronous)
    overrides = {k: getattr(args, k) for k in
                 ("buffer", "warmup", "filter_thresh", "keyframe_thresh")
                 if getattr(args, k) is not None}
    if args.image_size is not None:
        overrides["image_size"] = tuple(args.image_size)
    cfg = dataclasses.replace(cfg, **overrides)
    droid = make_droid(cfg, device=args.device)

    stream = tum_stream(args.datapath, stride=2, image_size=cfg.image_size)
    for (t, image, intrinsics) in stream:
        droid.track(t, image, intrinsics=intrinsics)

    traj_est = droid.terminate(iter(stream),
                               backend_steps=tuple(args.backend_steps))

    tstamps = tum_timestamps(args.datapath, stride=2)
    gt_file = os.path.join(args.datapath, "groundtruth.txt")
    gt = np.loadtxt(gt_file, skiprows=1 if _has_header(gt_file) else 0)
    result = evaluate_ate(traj_est[:, :3], gt[:, 1:4],
                          t_est=tstamps[:len(traj_est)], t_ref=gt[:, 0],
                          scale=True, max_dt=0.02)
    print(f"ATE RMSE: {result['ate_rmse']:.4f} m "
          f"({result['n_matches']} matches)")


if __name__ == "__main__":
    main()
