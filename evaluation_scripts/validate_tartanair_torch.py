"""TartanAir validation-split evaluation with the PyTorch/CUDA port: the
reserved validation scenes through the full pipeline, with their ATE, RPE
and KITTI metrics.

The flags and output of ``validate_tartanair.py``, plus ``--device`` (the
card unless ``--device cpu``):

    python evaluation_scripts/validate_tartanair_torch.py \
        --datapath TartanAir --weights checkpoints/r5_006000.npz
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from droid_slam_tpu_torch.config import PRESETS  # noqa: E402
from droid_slam_tpu_torch.data.tartan import (  # noqa: E402
    TEST_SPLIT, tartan_image_stream)
from droid_slam_tpu_torch.eval.ate import evaluate_ate, rpe  # noqa: E402
from droid_slam_tpu_torch.eval.kitti import kitti_metrics  # noqa: E402
from droid_slam_tpu_torch.utils.device import require_device  # noqa: E402


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--datapath", required=True,
                        help="TartanAir root directory")
    parser.add_argument("--weights", default=None)
    parser.add_argument("--scenes", nargs="+", default=None)
    parser.add_argument("--backend_steps", type=int, nargs="+",
                        default=[7, 12])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    require_device("validate_tartanair_torch.py", args.device)

    import dataclasses
    from droid_slam_tpu_torch.slam.droid import Droid

    scenes = args.scenes or TEST_SPLIT[:4]
    results = []
    for scene in scenes:
        scenedir = os.path.join(args.datapath, scene)
        if not os.path.isdir(scenedir):
            print(f"skipping missing scene {scene}")
            continue
        cfg = dataclasses.replace(PRESETS["tartanair"], weights=args.weights)
        droid = Droid(cfg, device=args.device)
        stream = list(tartan_image_stream(scenedir))
        for (t, image, intrinsics) in stream:
            droid.track(t, image, intrinsics=intrinsics)
        traj_est = droid.terminate(iter(stream),
                                   backend_steps=tuple(args.backend_steps))

        gt = np.loadtxt(os.path.join(scenedir, "pose_left.txt"),
                        delimiter=" ")[:, [1, 2, 0, 4, 5, 3, 6]]
        ate = evaluate_ate(traj_est[:, :3], gt[:, :3], scale=True)
        t_rel, r_rel = kitti_metrics(gt, traj_est)
        rpe_t, rpe_r = rpe(traj_est, gt)
        print(f"{scene}: ATE {ate['ate_rmse']:.4f} RPE {rpe_t:.4f}/"
              f"{rpe_r:.4f} KITTI {t_rel:.4f}/{r_rel:.6f}")
        results.append(ate["ate_rmse"])

    if results:
        print("Mean ATE", float(np.mean(results)))


if __name__ == "__main__":
    main()
