"""The port's evaluation entry points on the CPU: ``test_synthetic_torch.run``
against ``evaluation_scripts/test_synthetic.py``'s ``run``,
``view_reconstruction_torch.py`` against ``view_reconstruction.py``,
``test_euroc_torch.py`` end to end on the EuRoC fixture, and the live
viewer thread that ``enable_vis`` starts.

The synthetic runs track the same 16 frames at 64x96 (the scene of
``tests/test_torch_terminate.py``: seed 11, steps 0.12 and 0.04, every
frame admitted) with the tartanair preset and the trained weights; both
must keep the same keyframes, and their filled trajectories must agree to
that file's ATE bound (ATE_BETWEEN). The test prints its readings: 0.0066
between them, each 0.16 against the ground truth.
"""

import os
import runpy
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints", "r5_006000.npz")
ATE_BETWEEN = 0.05
SYN = dict(height=64, width=96, buffer=32, filter_thresh=-1.0, n_frames=16,
           step=0.12, rot_step=0.04, backend_steps=[7, 12])
SEED = 11


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several test processes at
    once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _script(*parts):
    return runpy.run_path(os.path.join(ROOT, *parts), run_name="not_main")


def test_synthetic_run_matches_jax(monkeypatch):
    if not os.path.exists(CKPT):
        pytest.skip(f"needs the trained checkpoint {CKPT}")
    from droid_slam_tpu.slam import droid as jdroid
    from droid_slam_tpu_torch.eval.ate import ate_rmse

    seen = {}
    terminate = jdroid.Droid.terminate

    def spy(self, *a, **k):
        out = terminate(self, *a, **k)
        seen.update(keyframes=self.video.counter, traj=out)
        return out

    monkeypatch.setattr(jdroid.Droid, "terminate", spy)
    args = types.SimpleNamespace(**SYN)
    want = _script("evaluation_scripts", "test_synthetic.py")["run"](
        args, SEED, weights=CKPT)
    args.device = "cpu"
    tracked = []
    report = dict(on_tracked=lambda d: tracked.append(d.video.counter))
    got = _script("evaluation_scripts", "test_synthetic_torch.py")["run"](
        args, SEED, weights=CKPT, report=report)
    between = ate_rmse(report["traj"][:, :3], seen["traj"][:, :3])[0]
    print("synthetic", dict(ate_jax=want, ate_torch=got, between=between,
                            keyframes=report["keyframes"]))
    assert report["keyframes"] == seen["keyframes"] >= 12
    assert len(tracked) == 1 and tracked[0] >= 12   # called once, tracked
    assert report["traj"].shape == seen["traj"].shape == (SYN["n_frames"], 7)
    assert np.isfinite(got) and np.isfinite(want)
    assert between <= ATE_BETWEEN
    assert report["track_s"] > 0 and report["terminate_stats"]["total_s"] > 0


def _saved_reconstruction(path, image_size, upsample, t=6, seed=0):
    """A reconstruction ``.npz`` with demo_torch.save_reconstruction's
    fields: t keyframes moving along +x before a wall at disparity ~1, 1/8
    scale intrinsics, disparities at 1/8 or (``upsample``) full size."""
    from droid_slam_tpu_torch.lie import se3

    rng = np.random.default_rng(seed)
    H, W = image_size
    h, w = (H, W) if upsample else (H // 8, W // 8)
    xi = np.zeros((t, 6), np.float32)
    xi[:, 0] = 0.05 * np.arange(t)
    xi[:, 3:] = 0.005 * rng.normal(size=(t, 3))
    np.savez(path, tstamps=np.arange(t, dtype=np.float32),
             poses=se3.exp(torch.as_tensor(xi)).numpy(),
             disps=(0.9 + 0.1 * rng.uniform(size=(t, h, w)))
             .astype(np.float32),
             intrinsics=np.tile(np.array([0.8 * W, 0.8 * W, W / 2, H / 2],
                                         np.float32) / 8, (t, 1)),
             images=rng.integers(0, 255, (t, H, W, 3)).astype(np.uint8))


def _read_ply(path):
    with open(path) as f:
        lines = f.read().splitlines()
    end = lines.index("end_header")
    n = int(lines[2].split()[-1])
    rows = np.array([ln.split() for ln in lines[end + 1:]],
                    np.float64).reshape(-1, 6)
    assert len(rows) == n
    return rows


def _jax_view(npz, ply, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["view_reconstruction.py",
                                      "--reconstruction_path", str(npz),
                                      "--ply", str(ply)])
    _script("view_reconstruction.py")["main"]()


@pytest.mark.parametrize("case", ["240x320", "320x512_upsample"])
def test_view_reconstruction_matches_jax(tmp_path, monkeypatch, case):
    """At 240x320 (a 30x40 plane) and with full-resolution disparities both
    scripts write the same cloud: the same points (to the PLY's 4 decimals,
    one unit of the last place apart at most) and colours."""
    size, upsample = ((240, 320), False) if case == "240x320" else \
        ((320, 512), True)
    npz = tmp_path / "r.npz"
    _saved_reconstruction(npz, size, upsample)
    _jax_view(npz, tmp_path / "jax.ply", monkeypatch)
    _script("view_reconstruction_torch.py")["main"](
        ["--reconstruction_path", str(npz), "--ply",
         str(tmp_path / "torch.ply"), "--device", "cpu"])
    got, want = _read_ply(tmp_path / "torch.ply"), \
        _read_ply(tmp_path / "jax.ply")
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(got[:, 3:], want[:, 3:])
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=0,
                               atol=1.0001e-4)


def test_view_reconstruction_at_320x512_without_upsample(tmp_path,
                                                         monkeypatch):
    """The tracker's 40x64 disparities of 320x512 images: JAX's script takes
    them for full resolution (40 % 8 == 0), subsamples them to 5x8 and
    fails on the colour mask; the port's decides by the images' shape and
    writes the cloud of the 40x64 plane, which JAX's depth filter and
    back-projection give on the same arrays."""
    import jax.numpy as jnp
    from droid_slam_tpu.geom import filters as jfilters

    npz = tmp_path / "r.npz"
    _saved_reconstruction(npz, (320, 512), upsample=False)
    with pytest.raises(IndexError, match="boolean index did not match"):
        _jax_view(npz, tmp_path / "jax.ply", monkeypatch)
    _script("view_reconstruction_torch.py")["main"](
        ["--reconstruction_path", str(npz), "--ply",
         str(tmp_path / "torch.ply"), "--device", "cpu"])
    got = _read_ply(tmp_path / "torch.ply")

    d = np.load(npz)
    poses, disps = jnp.asarray(d["poses"]), jnp.asarray(d["disps"])
    intr = jnp.asarray(d["intrinsics"][0])
    t = len(d["poses"])
    count = jfilters.depth_filter(poses, disps, intr, jnp.arange(t),
                                  0.005 * jnp.mean(disps, axis=(1, 2)))
    mask = np.asarray((count >= 2) & (disps > 0.5 * disps.mean()))
    pts = np.asarray(jfilters.iproj_points(poses, disps, intr))[mask]
    cols = d["images"][:, 3::8, 3::8][mask][:, ::-1]
    assert len(got) == len(pts) > 0
    np.testing.assert_array_equal(got[:, 3:], cols)
    np.testing.assert_allclose(got[:, :3], pts, rtol=0, atol=1.0001e-4)


# runs test_euroc_torch.py as __main__, then fails if JAX or the JAX
# package was imported
_RUNNER = (
    "import runpy, sys\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_path(sys.argv[0], run_name='__main__')\n"
    "bad = [m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'droid_slam_tpu')]\n"
    "assert not bad, bad\n"
    "print('no jax')\n")


def test_euroc_cli_on_the_fixture(tmp_path):
    pytest.importorskip("cv2")
    if not os.path.exists(CKPT):
        pytest.skip(f"needs the trained checkpoint {CKPT}")
    from droid_slam_tpu_torch.data.fixtures import write_euroc_fixture

    gt = write_euroc_fixture(str(tmp_path), n_frames=12)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-c", _RUNNER,
         os.path.join("evaluation_scripts", "test_euroc_torch.py"),
         "--datapath", str(tmp_path), "--gt", gt, "--weights", CKPT,
         "--image_size", "64", "96", "--buffer", "32", "--warmup", "5",
         "--filter_thresh", "-1", "--keyframe_thresh", "-1",
         "--backend_steps", "1", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    import re
    m = re.search(r"ATE RMSE: ([0-9.eE+-]+|nan|inf) m \(scale [0-9.]+, "
                  r"(\d+) matches\)", out.stdout)
    assert m is not None, out.stdout[-2000:]
    assert np.isfinite(float(m.group(1))) and int(m.group(2)) == 12
    assert "no jax" in out.stdout


def test_enable_vis_runs_the_viewer_until_terminate(tmp_path, monkeypatch):
    """``enable_vis`` starts the viewer thread; without a GL stack or Open3D
    it writes the live cloud to reconstruction_live.ply in the working
    directory once 4 keyframes are in; ``terminate()`` stops it."""
    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.data.synthetic import synthetic_stream
    from droid_slam_tpu_torch.slam.droid import Droid

    monkeypatch.chdir(tmp_path)
    droid = Droid(DroidConfig(image_size=(64, 96), buffer=16, warmup=8,
                              filter_thresh=-1.0, keyframe_thresh=-1.0,
                              enable_vis=True,
                              weights=CKPT if os.path.exists(CKPT) else None),
                  device="cpu")
    assert droid._vis_thread.is_alive() and droid._vis_thread.daemon
    for t, img, intr in synthetic_stream(n_frames=6, image_size=(64, 96),
                                         seed=SEED, step=0.12,
                                         rot_step=0.04):
        droid.track(float(t), img, intrinsics=intr)
    ply = tmp_path / "reconstruction_live.ply"
    deadline = time.time() + 60
    while not ply.exists() and time.time() < deadline:
        time.sleep(0.2)
    assert ply.exists()
    droid.terminate(backend_steps=(1,))
    droid._vis_thread.join(timeout=30)
    assert not droid._vis_thread.is_alive()
    time.sleep(0.5)   # let a write that was under way end
    print("live cloud", len(_read_ply(ply)), "points")
