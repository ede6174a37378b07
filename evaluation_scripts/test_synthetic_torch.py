"""Synthetic-scene evaluation with the PyTorch/CUDA port: a full SLAM run and
its ATE against the exact ground truth.

The flags and output of ``test_synthetic.py``, plus ``--device``: renders
the procedural box-scene trajectory (``droid_slam_tpu_torch/data/
synthetic.py``), tracks it with the tartanair preset at --height x --width,
runs ``terminate()`` (the global BA passes and the trajectory filler over
every frame) and prints the Sim3-aligned ATE RMSE against the exact
ground-truth poses. Runs on the card unless ``--device cpu``.

    python evaluation_scripts/test_synthetic_torch.py \
        --weights checkpoints/r5_006000.npz [--seeds 7 11] [--device cpu]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from droid_slam_tpu_torch.config import PRESETS  # noqa: E402
from droid_slam_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_groundtruth, synthetic_stream)
from droid_slam_tpu_torch.eval.ate import evaluate_ate  # noqa: E402
from droid_slam_tpu_torch.utils.device import require_device  # noqa: E402


def run(args, seed, weights=None, report=None):
    """Track the seed's synthetic sequence and return the ATE RMSE of the
    filled trajectory. With a dict ``report``, calls
    ``report["on_tracked"](droid)`` (when given) between tracking and
    ``terminate()``, and fills in the tracker (``droid``), its
    ``keyframes``, ``track_s`` (host seconds of tracking, the device
    synchronised; the frames are rendered before, in threads, and the
    filler takes the same frames), ``kf_per_s``,
    ``terminate_stats`` and the trajectory (``traj``, camera-to-world)."""
    import dataclasses

    import torch
    from droid_slam_tpu_torch.slam.droid import Droid

    device = getattr(args, "device", "cuda")
    cfg = dataclasses.replace(
        PRESETS["tartanair"], weights=weights,
        image_size=(args.height, args.width), buffer=args.buffer,
        filter_thresh=args.filter_thresh,
        asynchronous=getattr(args, "asynchronous", False))
    if cfg.asynchronous:
        from droid_slam_tpu_torch.slam.async_droid import DroidAsync
        droid = DroidAsync(cfg, device=device, sleep_time=2.0)
    else:
        droid = Droid(cfg, device=device)

    kw = dict(n_frames=args.n_frames, image_size=(args.height, args.width),
              seed=seed, step=args.step, rot_step=args.rot_step)
    frames = list(synthetic_stream(**kw,
                                   workers=min(8, os.cpu_count() or 1)))

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    sync()
    tic = time.perf_counter()
    for (t, image, intrinsics) in frames:
        droid.track(float(t), image, intrinsics=intrinsics)
    sync()
    track_s = time.perf_counter() - tic
    if report is not None and "on_tracked" in report:
        report["on_tracked"](droid)
    if cfg.asynchronous:
        traj_est = droid.terminate(iter(frames))
    else:
        traj_est = droid.terminate(iter(frames),
                                   backend_steps=tuple(args.backend_steps))

    gt = synthetic_groundtruth(**kw)
    result = evaluate_ate(traj_est[:, :3], gt[:, :3], scale=True)
    if report is not None:
        n = droid.video.counter
        report.update(droid=droid, keyframes=n, track_s=track_s,
                      kf_per_s=n / track_s,
                      terminate_stats=droid.terminate_stats, traj=traj_est)
    return result["ate_rmse"]


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--weights", default=None)
    parser.add_argument("--n_frames", type=int, default=120)
    parser.add_argument("--height", type=int, default=320)
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--buffer", type=int, default=256)
    parser.add_argument("--step", type=float, default=0.10)
    parser.add_argument("--rot_step", type=float, default=0.03)
    parser.add_argument("--filter_thresh", type=float, default=1.75)
    parser.add_argument("--seeds", type=int, nargs="+", default=[7])
    parser.add_argument("--backend_steps", type=int, nargs="+",
                        default=[7, 12])
    parser.add_argument("--asynchronous", action="store_true",
                        help="DroidAsync (the global BA in a thread beside "
                             "tracking) instead of the synchronous Droid")
    parser.add_argument("--compare_random", action="store_true",
                        help="also evaluate a random-init model in the same "
                             "process")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    require_device("test_synthetic_torch.py", args.device)

    variants = [("weights", args.weights)]
    if args.compare_random or args.weights is None:
        variants += [("random-init", None)]
        if args.weights is None:
            variants = variants[1:]

    results = {}
    for tag, weights in variants:
        ates = []
        for seed in args.seeds:
            ate = run(args, seed, weights=weights)
            ates.append(ate)
            print(f"[{tag}] seed {seed}: ATE RMSE {ate:.4f}", flush=True)
        results[tag] = float(np.mean(ates))
        print(f"[{tag}] mean ATE RMSE over {len(ates)} seeds: "
              f"{results[tag]:.4f}", flush=True)
    if len(results) > 1:
        print("summary:", {k: round(v, 4) for k, v in results.items()})


if __name__ == "__main__":
    main()
