"""The port's demo CLI (``demo_torch.py``) on the CPU: a dozen PNGs written
with cv2, tracked synchronously and with ``--asynchronous`` (the backend
thread, and the backend process under DROID_ASYNC_PROCESS=1). Each run
writes the trajectory [T,7] and the reconstruction ``.npz`` with
``demo.py``'s fields, and imports neither JAX nor the JAX package (checked
on ``sys.modules`` inside the run's own interpreter); ``--screenshot``
writes a PNG of the reconstruction."""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints", "r5_006000.npz")
N_IMAGES = 12
FIELDS = {"tstamps", "poses", "disps", "intrinsics", "images"}

# runs demo_torch.main at 64x96 (the CLI's resize target is 384x512, too
# large for the CPU), then fails if JAX or the JAX package was imported
_RUNNER = (
    "import sys\n"
    "import demo_torch\n"
    "demo_torch.TARGET_AREA = 64 * 96\n"
    "demo_torch.main(sys.argv[1:])\n"
    "bad = [m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'droid_slam_tpu')]\n"
    "assert not bad, bad\n"
    "print('no jax')\n")


@pytest.fixture(scope="module")
def imagedir(tmp_path_factory):
    import cv2

    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, size=(192, 256, 3)).astype(np.uint8)
    for t in range(N_IMAGES):
        cv2.imwrite(str(d / f"{t:04d}.png"), np.roll(base, 6 * t, axis=1))
    calib = d / "calib.txt"
    calib.write_text("120.0 120.0 128.0 96.0\n")
    return d, calib


def _run(imagedir, tmp_path, *flags, env=None):
    d, calib = imagedir
    traj, recon = tmp_path / "traj.txt", tmp_path / "recon.npz"
    args = ["--imagedir", str(d), "--calib", str(calib), "--device", "cpu",
            "--weights", CKPT, "--buffer", "32", "--warmup", "4",
            "--filter_thresh", "-1", "--keyframe_thresh", "-1",
            "--backend_steps", "2", "--trajectory_path", str(traj),
            "--reconstruction_path", str(recon), *flags]
    run_env = {k: v for k, v in os.environ.items()
               if k not in ("PYTHONPATH", "DROID_ASYNC_PROCESS")}
    run_env.update(OMP_NUM_THREADS="2", **(env or {}))
    out = subprocess.run([sys.executable, "-c", _RUNNER, *args], cwd=ROOT,
                         env=run_env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "no jax" in out.stdout
    return np.loadtxt(traj), np.load(recon)


@pytest.mark.parametrize("mode", ["sync", "thread", "process"])
def test_demo_cli_writes_trajectory_and_reconstruction(imagedir, tmp_path,
                                                       mode):
    if not os.path.exists(CKPT):
        pytest.skip(f"needs the trained checkpoint {CKPT}")
    flags = [] if mode == "sync" else ["--asynchronous"]
    env = {"DROID_ASYNC_PROCESS": "1"} if mode == "process" else None
    traj, recon = _run(imagedir, tmp_path, *flags, env=env)
    assert traj.shape == (N_IMAGES, 7) and np.isfinite(traj).all()
    np.testing.assert_allclose(np.linalg.norm(traj[:, 3:], axis=1), 1.0,
                               atol=1e-5)
    assert set(recon.files) == FIELDS
    t = len(recon["tstamps"])
    assert t == N_IMAGES   # every image a keyframe
    h, w = recon["images"].shape[1:3]
    assert recon["images"].shape == (t, h, w, 3)
    assert recon["poses"].shape == (t, 7)
    assert recon["disps"].shape == (t, h // 8, w // 8)
    assert recon["intrinsics"].shape == (t, 4)
    assert np.isfinite(recon["disps"]).all()


def test_demo_cli_screenshot_writes_a_png(imagedir, tmp_path):
    """--screenshot renders the final reconstruction offscreen to a PNG
    (written without cv2) that cv2 decodes: 480x640, not all background."""
    import cv2

    if not os.path.exists(CKPT):
        pytest.skip(f"needs the trained checkpoint {CKPT}")
    shot = tmp_path / "shot.png"
    _run(imagedir, tmp_path, "--screenshot", str(shot))
    img = cv2.imread(str(shot))
    assert img is not None and img.shape == (480, 640, 3)
    background = (np.array([0.10, 0.09, 0.09]) * 255).astype(np.uint8)
    assert (img != background).any(axis=-1).mean() > 0.001
