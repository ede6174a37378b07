"""TartanAir test-set evaluation with the PyTorch/CUDA port: mono or stereo,
the NED ground truth remapped to xyz, and the ATE with a scale correction
(mono) or STEREO_SCALE_FACTOR (stereo).

The flags and output of ``test_tartanair.py``, plus ``--device`` (the card
unless ``--device cpu``):

    python evaluation_scripts/test_tartanair_torch.py --datapath mono \
        --gt_path mono_gt --weights checkpoints/r5_006000.npz [--scene ME000]
"""

import argparse
import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from droid_slam_tpu_torch.config import (  # noqa: E402
    PRESETS, STEREO_SCALE_FACTOR)
from droid_slam_tpu_torch.eval.ate import evaluate_ate  # noqa: E402
from droid_slam_tpu_torch.slam import make_droid  # noqa: E402
from droid_slam_tpu_torch.utils.device import require_device  # noqa: E402

MONO_TEST_SCENES = [f"M{s}{i:03d}" for s in ["E", "H"] for i in range(8)]
STEREO_TEST_SCENES = [f"S{s}{i:03d}" for s in ["E", "H"] for i in range(8)]


def image_stream(datapath, image_size=(384, 512), stereo=False):
    """Each image resized to 384x512, the intrinsics scaled by 0.8."""
    import cv2

    if stereo or os.path.exists(os.path.join(datapath, "image_left")):
        images_left = sorted(glob.glob(
            os.path.join(datapath, "image_left/*.png")))
        images_right = sorted(glob.glob(
            os.path.join(datapath, "image_right/*.png")))
    else:
        images_left = sorted(glob.glob(os.path.join(datapath, "*.png")))
        images_right = []

    intr = 0.8 * np.array([320.0, 320.0, 320.0, 240.0], np.float32)
    data = []
    for t in range(len(images_left)):
        images = [cv2.resize(cv2.imread(images_left[t]),
                             (image_size[1], image_size[0]))]
        if stereo:
            images.append(cv2.resize(cv2.imread(images_right[t]),
                                     (image_size[1], image_size[0])))
        img = np.stack(images) if stereo else images[0]
        data.append((t, img, intr))
    return data


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--datapath", required=True)
    parser.add_argument("--gt_path", required=True)
    parser.add_argument("--weights", default=None)
    parser.add_argument("--asynchronous", action="store_true")
    parser.add_argument("--stereo", action="store_true")
    parser.add_argument("--scene", default=None)
    parser.add_argument("--backend_steps", type=int, nargs="+",
                        default=[7, 12])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    require_device("test_tartanair_torch.py", args.device)

    import dataclasses
    scenes = [args.scene] if args.scene else (
        STEREO_TEST_SCENES if args.stereo else MONO_TEST_SCENES)

    ate_list = []
    for scene in scenes:
        cfg = dataclasses.replace(PRESETS["tartanair"], stereo=args.stereo,
                                  weights=args.weights,
                                  asynchronous=args.asynchronous)
        droid = make_droid(cfg, device=args.device)
        scenedir = os.path.join(args.datapath, scene)
        stream = image_stream(scenedir, stereo=args.stereo)
        for (t, image, intrinsics) in stream:
            droid.track(t, image, intrinsics=intrinsics)

        traj_est = droid.terminate(iter(stream),
                                   backend_steps=tuple(args.backend_steps))
        if args.stereo:
            traj_est[:, :3] *= STEREO_SCALE_FACTOR

        gt = np.loadtxt(os.path.join(args.gt_path, f"{scene}.txt"),
                        delimiter=" ")[:, [1, 2, 0, 4, 5, 3, 6]]
        result = evaluate_ate(traj_est[:, :3], gt[:, :3],
                              scale=not args.stereo)
        print(f"{scene}: ATE {result['ate_rmse']:.4f}")
        ate_list.append(result["ate_rmse"])

    print("Mean ATE", float(np.mean(ate_list)))


if __name__ == "__main__":
    main()
