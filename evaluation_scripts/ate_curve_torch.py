"""ATE against training steps on synthetic sequences, with the PyTorch/CUDA
port: each checkpoint (and the random-init baseline) over several seeds in
one process. Writes a markdown table and a JSON file.

The flags and output of ``ate_curve.py``, plus ``--device`` (the card
unless ``--device cpu``):

    python evaluation_scripts/ate_curve_torch.py \
        --ckpts checkpoints/r5_00*.npz --seeds 7 11 13
"""

import argparse
import json
import os
import re
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from test_synthetic_torch import run  # noqa: E402  (same directory)
from droid_slam_tpu_torch.utils.device import require_device  # noqa: E402


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ckpts", nargs="+", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", default=[7, 11, 13])
    parser.add_argument("--n_frames", type=int, default=80)
    parser.add_argument("--height", type=int, default=160)
    parser.add_argument("--width", type=int, default=240)
    parser.add_argument("--buffer", type=int, default=64)
    parser.add_argument("--step", type=float, default=0.10)
    parser.add_argument("--rot_step", type=float, default=0.03)
    parser.add_argument("--filter_thresh", type=float, default=1.75)
    parser.add_argument("--backend_steps", type=int, nargs="+",
                        default=[7, 12])
    parser.add_argument("--skip_random", action="store_true")
    parser.add_argument("--out", default="runs/ate_curve_torch.json")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    require_device("ate_curve_torch.py", args.device)

    variants = [] if args.skip_random else [("random-init", None)]
    for ck in args.ckpts:
        m = re.search(r"(\d+)\.npz$", ck)
        step = int(m.group(1)) if m else -1
        variants.append((f"step {step:>6d}" if step >= 0 else ck, ck))

    rows = []
    for tag, weights in variants:
        ates = []
        for seed in args.seeds:
            try:
                ate = float(run(args, seed, weights=weights))
            except Exception as e:  # a divergent track scores inf
                print(f"[{tag}] seed {seed}: FAILED ({e})", flush=True)
                ate = float("inf")
            print(f"[{tag}] seed {seed}: ATE RMSE {ate:.4f}", flush=True)
            ates.append(ate)
        rows.append({"tag": tag, "weights": weights,
                     "ates": ates, "mean": float(np.mean(ates))})
        print(f"[{tag}] mean over {len(ates)} seeds: "
              f"{rows[-1]['mean']:.4f}", flush=True)

    print("\n| checkpoint | " + " | ".join(f"seed {s}" for s in args.seeds)
          + " | mean |")
    print("|---" * (len(args.seeds) + 2) + "|")
    for r in rows:
        cells = " | ".join(f"{a:.4f}" for a in r["ates"])
        print(f"| {r['tag']} | {cells} | **{r['mean']:.4f}** |")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"config": vars(args), "rows": rows}, f, indent=1)
    print(f"\nwrote {args.out}")


if __name__ == "__main__":
    main()
