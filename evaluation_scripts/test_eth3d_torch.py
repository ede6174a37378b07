"""ETH3D-SLAM RGB-D evaluation with the PyTorch/CUDA port: tracking with the
depth sensor, and the ATE without a scale correction.

The flags and output of ``test_eth3d.py``, plus ``--device`` (the card
unless ``--device cpu``):

    python evaluation_scripts/test_eth3d_torch.py --datapath sofa_1 \
        --weights checkpoints/r5_006000.npz
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from droid_slam_tpu_torch.config import PRESETS  # noqa: E402
from droid_slam_tpu_torch.data.stream import (  # noqa: E402
    eth3d_stream, eth3d_timestamps)
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
    # the tuned ETH3D hyperparameters of PRESETS["eth3d"]; --image_size
    # sets the area of the resize, 384x512 by default)
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
    require_device("test_eth3d_torch.py", args.device)

    import dataclasses
    area = (args.image_size[0] * args.image_size[1]
            if args.image_size is not None else 384 * 512)
    frames = list(eth3d_stream(args.datapath, use_depth=True,
                               target_area=area))
    h, w = frames[0][1].shape[:2]
    cfg = dataclasses.replace(PRESETS["eth3d"], depth=True,
                              image_size=(h, w), weights=args.weights,
                              asynchronous=args.asynchronous)
    overrides = {k: getattr(args, k) for k in
                 ("buffer", "warmup", "filter_thresh", "keyframe_thresh")
                 if getattr(args, k) is not None}
    cfg = dataclasses.replace(cfg, **overrides)
    droid = make_droid(cfg, device=args.device)
    for (t, image, depth, intrinsics) in frames:
        droid.track(t, image, depth=depth, intrinsics=intrinsics)

    stream = iter([(t, im, intr) for (t, im, _, intr) in frames])
    traj_est = droid.terminate(stream,
                               backend_steps=tuple(args.backend_steps))

    gt = np.loadtxt(os.path.join(args.datapath, "groundtruth.txt"),
                    skiprows=1)
    tstamps = eth3d_timestamps(args.datapath)
    result = evaluate_ate(traj_est[:, :3], gt[:, 1:4],
                          t_est=tstamps[:len(traj_est)], t_ref=gt[:, 0],
                          scale=False, max_dt=0.02)  # RGB-D: metric scale
    print(f"ATE RMSE: {result['ate_rmse']:.4f} m "
          f"({result['n_matches']} matches)")


if __name__ == "__main__":
    main()
