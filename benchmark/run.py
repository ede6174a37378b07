"""Runs one cell of the benchmark once and prints its result as the last line
of standard output.

    python benchmark/run.py --workload euroc_mono.track --seed 7 \
        --seconds 30 --trace 0

The program under test is ``droid_slam_tpu_torch`` on CUDA. The cell's
inputs are made from ``--seed``; set-up (imports, the kernels' build,
weights, the stream, warm-up) is timed from the process's start; then the
loop of the cell's traffic runs for ``--seconds``; after it, what the
window produced is compared with the plain reference under ``reference/``.
``--trace 1`` runs the window under ``torch.profiler`` and reports the
per-layer metrics instead of the end-to-end ones. The compared numbers and
their limits are the last lines of standard error and the last key of the
result."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the package's parent in place of this file's folder, whose module names
# would shadow the standard library's
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def run_cell(workload, seed, seconds, trace, device="cuda", overrides=None,
             control=False, t_start=None):
    """One run of ``workload``; returns the result record. ``overrides``
    replaces keys of the configuration and the traffic (small CPU runs);
    ``control`` also computes the control's readings."""
    import torch
    cell = harness.Cell(workload)
    for part, vals in (overrides or {}).items():
        getattr(cell, part).update(vals)
    device = torch.device(device)
    out = cell.loop().run(cell, seed=seed, seconds=seconds,
                          trace=bool(trace), device=device,
                          t_start=T_START if t_start is None else t_start,
                          control=control)
    bad = harness.forbidden_modules()
    if bad:
        raise RuntimeError(f"the run loaded {bad}")
    correct, checks = harness.judge(out["readings"], cell.limits)
    names = [m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)]
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = out["metrics"].get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": out["device"]}
    if trace and out.get("breakdown") is not None:
        result["breakdown"] = out["breakdown"]
    result["info"] = out.get("info", {})
    if control:
        result["control"] = out.get("control")
    rest = {k: v for k, v in out["readings"].items() if k not in checks}
    if rest:
        # read, but not compared: the control does not separate them
        result["info"]["readings_not_compared"] = rest
    result["checks"] = checks
    missing = [n for n in names if n not in metrics]
    if missing:
        result["info"]["not_read"] = missing
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="also compute the control's readings (the "
                         "reference in lower precision)")
    args = ap.parse_args(argv)

    import torch
    cell = harness.Cell(args.workload)
    chips = cell.workload["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, args.trace,
                      control=args.control)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
