"""The port stands alone: importing any of its modules (or chip_smoke.py,
demo_torch.py, train_torch.py, view_reconstruction_torch.py, the
evaluation scripts ``evaluation_scripts/*_torch.py``,
tools/bench_global_ba_torch.py or tools/frame_path_probe_torch.py) pulls in
neither JAX nor the JAX package,
and its entry points default to the GPU. The update operator's edge pass
(``state/edge_update.py``) sits below ``state/graph.py`` and
``parallel/``."""

import ast
import glob
import inspect
import os
import pkgutil
import runpy
import subprocess
import sys

import pytest
import torch

import droid_slam_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's evaluation command lines, the reconstruction viewer and the
# global-BA tool, each with the required arguments that get it past parsing
CLIS = {
    "view_reconstruction_torch.py": ["--reconstruction_path", "r.npz"],
    "evaluation_scripts/test_synthetic_torch.py": [],
    "evaluation_scripts/test_euroc_torch.py": ["--datapath", "d", "--gt",
                                               "g"],
    "evaluation_scripts/test_tum_torch.py": ["--datapath", "d"],
    "evaluation_scripts/test_eth3d_torch.py": ["--datapath", "d"],
    "evaluation_scripts/test_tartanair_torch.py": ["--datapath", "d",
                                                   "--gt_path", "g"],
    "evaluation_scripts/validate_tartanair_torch.py": ["--datapath", "d"],
    "evaluation_scripts/ate_curve_torch.py": ["--ckpts", "c.npz"],
    "tools/bench_global_ba_torch.py": [],
    "tools/frame_path_probe_torch.py": [],
}
SCRIPTS = sorted(CLIS)


def _modules():
    pkg = droid_slam_tpu_torch
    return [pkg.__name__] + [
        m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]


def test_every_module_imports_without_jax():
    mods = _modules()
    for m in ("ops.corr_cuda", "ops.alt_corr_cuda", "ops.gru", "ops.gru_cuda",
              "slam.backend",
              "slam.trajectory_filler", "slam.align", "slam.async_droid",
              "slam.async_process", "eval.ate", "lie.sim3", "ba.dense",
              "models.droidnet", "train.losses", "train.trainer",
              "train.logger", "data.rgbd_utils", "data.graph_utils",
              "data.augmentation", "data.base", "data.tartan",
              "data.factory", "data.synthetic", "data.fixtures",
              "data.stream", "geom.filters", "eval.kitti",
              "eval.visualization", "eval.viewer", "utils.trace",
              "utils.device", "parallel", "parallel.mesh",
              "parallel.frontend", "parallel.backend"):
        assert "droid_slam_tpu_torch." + m in mods
    code = (
        "import importlib, sys, runpy\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "runpy.run_path('demo_torch.py', run_name='not_main')\n"
        "runpy.run_path('train_torch.py', run_name='not_main')\n"
        f"for p in {SCRIPTS!r}:\n"
        "    runpy.run_path(p, run_name='not_main')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'droid_slam_tpu' or m.startswith('droid_slam_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


def _imported(path, package):
    """Every module that the file at ``path`` (a module of ``package``)
    imports, at its top or inside a function, as absolute names; ``from m
    import x`` gives both m and m.x."""
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = package.split(".")[:len(package.split(".")) + 1
                                            - node.level]
                base = ".".join(parts + ([base] if base else []))
            names += [base] + [f"{base}.{a.name}" for a in node.names]
    return names


def test_parallel_and_the_edge_pass_import_nothing_above_them():
    """``parallel/`` imports nothing from ``state/graph.py``, and
    ``state/edge_update.py`` nothing from ``state/graph.py`` or
    ``parallel/``: the edge pass has one home below both."""
    pkg = os.path.join(ROOT, "droid_slam_tpu_torch")
    graph = "droid_slam_tpu_torch.state.graph"
    files = {p: ("droid_slam_tpu_torch.parallel", (graph,))
             for p in glob.glob(os.path.join(pkg, "parallel", "*.py"))}
    assert len(files) >= 4
    files[os.path.join(pkg, "state", "edge_update.py")] = (
        "droid_slam_tpu_torch.state",
        (graph, "droid_slam_tpu_torch.parallel"))
    seen = {}
    for path, (package, banned) in files.items():
        seen[os.path.basename(path)] = names = _imported(path, package)
        bad = [n for n in names for b in banned
               if n == b or n.startswith(b + ".")]
        assert not bad, (path, bad)
    for name in ("frontend.py", "backend.py"):
        assert "droid_slam_tpu_torch.state.edge_update" in seen[name]


def test_train_torch_defaults_to_cuda_and_refuses_without_it():
    """train_torch.py's --device and init_train_state default to the card;
    without one, neither trains on the CPU unasked."""
    import runpy
    mod = runpy.run_path(os.path.join(ROOT, "train_torch.py"),
                         run_name="not_main")
    assert mod["build_parser"]().parse_args([]).device == "cuda"
    from droid_slam_tpu_torch.train.trainer import (TrainConfig,
                                                    init_train_state)
    default = inspect.signature(init_train_state).parameters["device"]
    assert default.default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_train_state(TrainConfig())
        with pytest.raises(SystemExit, match="CUDA is not available"):
            mod["main"](["--datasets", "synthetic"])


def test_droid_defaults_to_cuda_and_refuses_without_it():
    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.slam.droid import Droid

    default = inspect.signature(Droid.__init__).parameters["device"].default
    assert default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Droid(DroidConfig(image_size=(64, 96), buffer=8))


@pytest.mark.parametrize("process", [False, True], ids=["thread", "process"])
def test_make_droid_picks_the_async_facade_on_cuda_by_default(
        process, monkeypatch):
    """make_droid(asynchronous=True) gives DroidAsync, or DroidAsyncProcess
    under DROID_ASYNC_PROCESS=1; both default to the card and refuse to run
    without one (before they start a thread or a process)."""
    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.slam import make_droid
    from droid_slam_tpu_torch.slam.async_droid import DroidAsync
    from droid_slam_tpu_torch.slam.async_process import DroidAsyncProcess
    from droid_slam_tpu_torch.slam.droid import Droid

    cls = DroidAsyncProcess if process else DroidAsync
    monkeypatch.setenv("DROID_ASYNC_PROCESS", "1" if process else "0")
    default = inspect.signature(cls.__init__).parameters["device"].default
    assert default == "cuda"
    built = []
    for c in (Droid, DroidAsync, DroidAsyncProcess):
        monkeypatch.setattr(c, "__init__",
                            lambda self, cfg, **kw: built.append(
                                (type(self), kw)))
    make_droid(DroidConfig(asynchronous=True), sleep_time=1.0)
    make_droid(DroidConfig())
    assert built == [(cls, {"sleep_time": 1.0}), (Droid, {})]
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(DroidConfig(image_size=(64, 96), buffer=8))


def test_droid_scopes_tf32_off_to_its_calls(monkeypatch):
    """track(), flush() and terminate() run with TF32 off (f32 geometry and
    BA) and give the caller back its own settings."""
    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.slam.droid import Droid

    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    for f in flags:
        monkeypatch.setattr(f, "allow_tf32", True)
    seen = []

    class Stage:
        def __call__(self, *args):
            seen.append([f.allow_tf32 for f in flags])

        finalize = track_begin = track_finish = __call__

    droid = Droid(DroidConfig(image_size=(64, 96), buffer=8), device="cpu")
    droid.frontend = droid.filterx = droid.backend = Stage()
    droid.track(0.0, None, intrinsics=None)
    droid.flush()
    droid.terminate(backend_steps=(1,))
    assert len(seen) == 13 and all(s == [False, False] for s in seen)
    assert [f.allow_tf32 for f in flags] == [True, True]


def test_track_takes_depth_third_as_jax_does():
    """``track(tstamp, image, depth=None, intrinsics=None)`` as in the JAX
    package: a positional ``None`` depth with positional intrinsics tracks
    exactly as the keyword form, and a depth map (RGB-D) is taken, not
    refused: it lands in ``disps_sens`` as inverse depth."""
    import numpy as np
    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.slam.droid import Droid

    h, w = 64, 96
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, size=(h, w, 3)).astype(np.uint8)
    intr = np.array([60.0, 60.0, w / 2, h / 2], np.float32)
    cfg = DroidConfig(image_size=(h, w), buffer=8, warmup=3,
                      filter_thresh=-1.0, keyframe_thresh=-1.0)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        runs = []
        for positional in (True, False):
            droid = Droid(cfg, device="cpu")
            for t in range(5):
                img = np.roll(base, 3 * t, axis=1)
                if positional:
                    droid.track(float(t), img, None, intr)
                else:
                    droid.track(float(t), img, intrinsics=intr)
            droid.flush()
            k = droid.video.counter
            runs.append((k, droid.video.poses[:k].clone(),
                         droid.video.disps[:k].clone()))
        droid = Droid(cfg, device="cpu")
        depth = np.full((h, w), 2.0, np.float32)
        for t in range(2):
            droid.track(float(t), base, depth, intr)
        droid.flush()
    finally:
        torch.set_num_threads(n)
    assert droid.video.counter == 2
    assert torch.equal(droid.video.disps_sens[:2],
                       torch.full((2, h // 8, w // 8), 0.5))
    (k1, p1, d1), (k2, p2, d2) = runs
    assert k1 == k2 == 5
    assert torch.equal(p1, p2) and torch.equal(d1, d2)


def test_f32_scopes_hold_across_threads(monkeypatch):
    """Threads entering and leaving ``f32_matmuls`` at once (the tracker and
    the asynchronous backend's thread): TF32 stays off inside every open
    scope, and the caller's settings come back when the last one closes."""
    import sys
    import threading

    from droid_slam_tpu_torch.slam.droid import f32_matmuls

    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    for f in flags:
        monkeypatch.setattr(f, "allow_tf32", True)
    bad, interval = [], sys.getswitchinterval()

    def work():
        for _ in range(300):
            with f32_matmuls():
                if any(f.allow_tf32 for f in flags):
                    bad.append(1)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not bad
    assert [f.allow_tf32 for f in flags] == [True, True]


@pytest.mark.parametrize("script", SCRIPTS)
def test_cli_defaults_to_cuda_and_refuses_without_it(script):
    """Each evaluation script, view_reconstruction_torch.py and the global-BA
    tool: --device is cuda unless given; without CUDA the script exits with
    a message before it reads anything (the paths it is given do not
    exist)."""
    mod = runpy.run_path(os.path.join(ROOT, script), run_name="not_main")
    parse = mod.get("build_parser")
    args = (parse().parse_args(CLIS[script]) if parse
            else mod["parse_args"](CLIS[script]))
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            mod["main"](CLIS[script])
