"""The synthetic evaluation scene tracked on each tracking path, frame by frame.

Renders ``evaluation_scripts/test_synthetic_torch.py``'s scene (the box
scene of ``droid_slam_tpu_torch/data/synthetic.py``, seed --seed, --n_frames
frames at --height x --width) once, then tracks it with the tartanair preset
(buffer 256, filter_thresh 1.75, the trained weights) once per entry of
--runs, runs ``terminate()`` (global-BA passes of 7 and 12 steps and the
filler) and prints one JSON line a run: the keyframes, the Sim3-aligned ATE
RMSE to the exact ground truth, the tracking seconds, the speculation
counters (mis-speculations, strict re-runs, proposals without probed
distances), every frame-program readback in the order the host first read
it ([keyframe distance, admission delta]; a mis-speculated frame's among
them) and the keyframe counter after each frame. A run is named by its
parts, joined by "_":
  strict   the strict path (``fused_frame=False``);
  frame    the frame path without speculation;
  spec     the frame path with speculative dispatch;
  eager    (with frame or spec) the frame programs run eagerly, not as CUDA
           graph replays;
  det      PyTorch's deterministic kernels;
  fresh    (with spec) a diagnostic variant, not a path of the port: the
           distances probed ahead are dropped at every keyframe removal,
           so that the next proposal computes its own (JAX's speculation
           keys them by the keyframe count alone, which a removal and the
           next admission restore, frames shifted).
This is how the collapse of speculation on this scene was read
(``ROADMAP.md`` §3 item 16). Runs on the card unless ``--device cpu``.

    python tools/frame_path_probe_torch.py --runs spec spec_eager spec_det frame
    python tools/frame_path_probe_torch.py --height 64 --width 96 \
        --n_frames 16 --runs frame spec --device cpu
"""

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from droid_slam_tpu_torch.utils.device import require_device  # noqa: E402

CKPT = os.path.join(ROOT, "checkpoints", "r5_006000.npz")


def track(frames, gt, args, run):
    """One run (``run``: its name, as the module's docstring lists the
    parts); returns its record."""
    import torch
    from droid_slam_tpu_torch.config import PRESETS
    from droid_slam_tpu_torch.eval.ate import evaluate_ate
    from droid_slam_tpu_torch.slam import fused_frame
    from droid_slam_tpu_torch.slam.droid import Droid

    parts = set(run.split("_"))
    if not parts <= {"strict", "frame", "spec", "eager", "det",
                     "fresh"} or \
            len(parts & {"strict", "frame", "spec"}) != 1 or \
            {"strict", "eager"} <= parts or \
            ("fresh" in parts and "spec" not in parts):
        raise ValueError(f"run {run!r}: one of strict, frame, spec, with "
                         f"eager, det or (with spec) fresh")
    cfg = dataclasses.replace(
        PRESETS["tartanair"], weights=args.weights,
        image_size=(args.height, args.width), buffer=256,
        filter_thresh=1.75, fused_frame="strict" not in parts,
        spec_frame="spec" in parts)
    readback = []
    numpy = fused_frame.Readback.numpy

    def logged(self):
        vec = numpy(self)
        if not getattr(self, "logged", False):
            self.logged = True
            readback.append([float(vec[0]), float(vec[1])])
        return vec

    cuda = torch.device(args.device).type == "cuda"
    fused_frame.Readback.numpy = logged
    torch.use_deterministic_algorithms("det" in parts)
    try:
        droid = Droid(cfg, device=args.device)
        if "eager" in parts:
            droid.frame_programs.graphs = False
        if "fresh" in parts:
            finalize, f = droid.frontend.finalize, droid.frontend

            def forgetting(kf_value=None):
                if kf_value is not None and \
                        kf_value < 2 * f.keyframe_thresh:
                    droid._dist_ring.clear()
                return finalize(kf_value=kf_value)

            f.finalize = forgetting
        counters = []
        if cuda:
            torch.cuda.synchronize()
        tic = time.perf_counter()
        for t, image, intrinsics in frames:
            droid.track(float(t), image, intrinsics=intrinsics)
            counters.append(droid.video.counter)
        if cuda:
            torch.cuda.synchronize()
        track_s = time.perf_counter() - tic
        keyframes = droid.video.counter
        traj = droid.terminate(iter(frames), backend_steps=(7, 12))
    finally:
        fused_frame.Readback.numpy = numpy
        torch.use_deterministic_algorithms(False)
    ate = evaluate_ate(traj[:, :3], gt[:, :3], scale=True)["ate_rmse"]
    return dict(run=run, size=[args.height, args.width], seed=args.seed,
                keyframes=keyframes, ate_rmse=float(ate), track_s=track_s,
                spec_mis=droid.spec_mis, strict_reruns=droid.strict_reruns,
                spec_dist_miss=droid.spec_dist_miss, readback=readback,
                counters=counters)


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--runs", nargs="+",
                        default=["spec", "spec_eager", "spec_det", "frame"])
    parser.add_argument("--height", type=int, default=320)
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--n_frames", type=int, default=120)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--weights", default=CKPT)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    require_device("frame_path_probe_torch.py", args.device)
    # cuBLAS's deterministic mode needs a fixed workspace before its first
    # handle
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from droid_slam_tpu_torch.data.synthetic import (synthetic_groundtruth,
                                                     synthetic_stream)

    kw = dict(n_frames=args.n_frames, image_size=(args.height, args.width),
              seed=args.seed, step=0.10, rot_step=0.03)
    frames = list(synthetic_stream(**kw, workers=min(8, os.cpu_count() or 1)))
    gt = synthetic_groundtruth(**kw)
    for run in args.runs:
        print(json.dumps(track(frames, gt, args, run)), flush=True)


if __name__ == "__main__":
    main()
