"""The harness on the CPU: BENCHMARK.json against the benchmark's contract,
each cell's files found by name, a small run of each cell printing a
complete result, the device renderer against the numpy copy of the scene,
and the stream guard."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from benchmark import harness
from benchmark.tests._dry import ROOT, dry_run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_json_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and _line(c["why"])
        assert _line(c["source"]) and c["source"].startswith("https://")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        names.append(c["name"])
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        pairs.add((w["config"], w["traffic"]))
        names.append(w["name"])
    assert len(pairs) == len(SPEC["workloads"])
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", CELLS)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for cell in CELLS:
        reported = [m for m in SPEC["end_to_end"]
                    if cell in m.get("workloads", CELLS)]
        assert "setup_s" in [m["name"] for m in reported]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])


@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_finds_its_files_by_name(workload):
    cell = harness.Cell(workload)
    assert cell.config["weights"] and cell.traffic["loop"]
    assert cell.loop().run
    assert cell.limits is not None and set(cell.limits)
    for m in cell.per_layer:
        reader = harness.metric_reader(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (
            m["layer"], m["unit"], m["moves"])


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_small_run_prints_every_metric(workload, trace):
    r = dry_run(workload, trace=trace)
    assert set(r) >= {"correct", "attempted", "failed", "metrics",
                      "device", "checks"}
    assert list(r)[-1] == "checks"
    assert r["attempted"] > 0 and r["failed"] == 0
    cell = harness.Cell(workload)
    want = cell.per_layer if trace else cell.end_to_end
    # the CPU has no device trace and no peak to divide by
    want = {m["name"] for m in want if m["source"] != "device_trace"}
    assert want <= set(r["metrics"])
    for c in r["checks"].values():
        assert np.isfinite(c["value"]) and c["limit"] is not None
    json.dumps(r)


def test_device_renderer_equals_the_numpy_scene():
    import torch
    from benchmark.traffic import box_walk
    Rs, ts, seed, intr = box_walk.walk(5, (48, 64), 2 ** 33 + 5, 0.1, 0.03)
    got = box_walk.render_torch(Rs, ts, intr, (48, 64), seed,
                                torch.device("cpu"), batch=2)
    want = np.stack([box_walk.render_numpy(R, t, intr, (48, 64), seed)[0]
                     for R, t in zip(Rs, ts)])
    diff = np.abs(got.astype(int) - want.astype(int))
    # float32 sums in another order move a value by one level at most,
    # rarely
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def test_stream_guard_fails_loudly():
    with pytest.raises(RuntimeError, match="ran out|buffer full"):
        dry_run("euroc_mono.track", overrides={"config": {"buffer": 60}},
                seconds=600)
