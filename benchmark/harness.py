"""What every run shares: the cell's files found by name, the checks on the
environment, the device's record and the result line.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration, ``configs/<config>.json``, and a traffic mix,
``traffic/<traffic>.json``, whose ``loop`` names the code that drives the
program (``loops/<loop>.py``); its limits are ``limits/<workload>.json``.
A per-layer metric is read by ``metrics/<metric>.py``."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "droid_slam_tpu")


def _json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


class Cell:
    """One workload with its configuration, traffic, limits and metrics."""

    def __init__(self, name, bench=None):
        bench = bench or spec()
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise SystemExit(f"unknown workload {name!r}; known: "
                             f"{sorted(by_name)}")
        self.name = name
        self.workload = w = by_name[name]
        cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
        with open(os.path.join(ROOT, cfg["file"])) as f:
            self.config = json.load(f)
        self.traffic = _json("traffic", w["traffic"] + ".json")
        path = os.path.join(HERE, "limits", name + ".json")
        self.limits = _json("limits", name + ".json") \
            if os.path.exists(path) else None
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    def loop(self):
        return importlib.import_module("benchmark.loops."
                                       + self.traffic["loop"])


def metric_reader(name):
    """The module of ``metrics/<name>.py`` (names may hold dots)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    mod_name = "benchmark.metrics." + name.replace(".", "__")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    sys.modules[mod_name] = mod
    return mod


def forbidden_modules():
    """Loaded modules whose top-level name is the JAX package's, JAX's or
    flax's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def weights_path(config):
    return os.path.join(ROOT, config["weights"])


def device_record(device, n):
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": n,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": n,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(d)
                                         for d in range(n)))}


def power_limit():
    """nvidia-smi's name and power limit of the card, or None."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def judge(readings, limits):
    """(correct, the compared numbers each beside its limit)."""
    if limits is None:
        return False, {k: {"value": v, "limit": None}
                       for k, v in readings.items()}
    missing = set(limits) - set(readings)
    if missing:
        raise RuntimeError(f"no reading of {sorted(missing)}")
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    ok = all(c["value"] is not None and c["value"] == c["value"]
             and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def trace_dir():
    """A fresh directory under the run's TMPDIR for a traced run's
    summary."""
    import tempfile
    return tempfile.mkdtemp(prefix="droid_bench_trace_")


def read_metrics(cell, ctx):
    """{name: value} of the cell's per-layer metrics whose readers found
    something to read."""
    out = {}
    for m in cell.per_layer:
        v = metric_reader(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = float(v)
    return out
