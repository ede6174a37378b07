"""The stereo cell on the CPU: a small run of ``euroc_stereo.track`` that
holds stereo edges and reads its new metrics, the right view of the
stereo stream against the numpy renderer at the moved camera, the stereo
frame's encoder count against ``torch.utils.flop_counter``, the check's
refusal of a window without stereo edges, and a run that loads no JAX
(``test_bench_imports.py``'s subprocess, with this cell's small size,
which ``conftest.py`` adds to ``_dry.SMALL``)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests._dry import ROOT, dry_run

CELL = "euroc_stereo.track"


def test_small_run_holds_stereo_edges_and_reads_them():
    r = dry_run(CELL, trace=1)
    assert r["correct"], r["checks"]
    info = r["info"]
    assert sum(info["sampled_stereo_edges"]) > 0
    assert info["new_stereo_edges"] > 0
    assert info["update_stereo_edges"] >= info["new_stereo_edges"]
    per_update = r["metrics"]["stereo_edges_per_update.track_stereo"]
    assert per_update["value"] == info["update_stereo_edges"] \
        / info["updates"]
    assert 0 < per_update["value"] \
        < r["metrics"]["edges_per_update.track"]["value"]


def test_right_view_is_the_numpy_render_at_the_moved_camera():
    from benchmark.traffic import box_walk, box_walk_stereo
    size, n, baseline = (48, 64), 4, 0.1
    pairs, intr = box_walk_stereo.stream(n, size, 2 ** 33 + 5, 2 ** 31 + 9,
                                         0.1, 0.03, baseline,
                                         torch.device("cpu"))
    Rs, ts, _, _ = box_walk.walk(n, size, 2 ** 33 + 5, 0.1, 0.03)
    texture = int(np.random.default_rng(2 ** 31 + 9).integers(1, 2 ** 20))
    assert pairs.shape == (n, 2) + size + (3,)
    for k in range(n):
        for view, t in ((0, ts[k]),
                        (1, ts[k] + Rs[k] @ np.array([baseline, 0, 0],
                                                     np.float32))):
            want = box_walk.render_numpy(Rs[k], t, intr, size, texture)[0]
            diff = np.abs(pairs[k, view].astype(int) - want.astype(int))
            # float32 sums in another order move a value by one level at
            # most, rarely (test_bench_harness.py)
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    assert (pairs[:, 0] != pairs[:, 1]).mean() > 0.5


def test_stereo_encoder_count():
    from torch.utils.flop_counter import FlopCounterMode

    from droid_slam_tpu_torch.models import nets, weights
    params = weights.init_params(0)
    views = torch.zeros((2, 40, 56, 3), dtype=torch.uint8)
    with FlopCounterMode(display=False) as m:
        nets.extract_features(params, views, cnet_views=1)
    reader = harness.metric_reader("mfu.track_stereo")
    assert m.get_total_flops() == reader.encoders(40, 56)


def test_a_window_without_stereo_edges_fails_the_run():
    from benchmark import checks_stereo
    cell = harness.Cell(CELL)
    mono = {"ii": np.array([0, 1, 2]), "jj": np.array([1, 2, 1])}
    with pytest.raises(RuntimeError, match="stereo edge"):
        checks_stereo.tracking(cell, {"written": [], "deltas": [],
                                      "samples": [mono]},
                               None, None, torch.device("cpu"))


def test_a_stereo_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "import benchmark.tests.conftest;"
            "from benchmark.tests._dry import dry_run;"
            f"r = dry_run({CELL!r});"
            "from benchmark import harness; import json;"
            "print(json.dumps([harness.forbidden_modules(), r['correct']]))")
    env = dict(os.environ, OMP_NUM_THREADS="4")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], True]
