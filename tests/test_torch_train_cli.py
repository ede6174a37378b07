"""train_torch.py end to end on the CPU: the TartanAir fixture and the
synthetic scenes, its weights read back by the JAX package, its state
resumed, and its refusal of more devices than the machine has cards.

Each run goes in a subprocess from a temporary directory, where it writes
``checkpoints/``; ``--iters 2 --batch 1`` keeps the unroll small.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--n_frames", "5", "--image_size", "96", "128",
         "--iters", "2", "--batch", "1", "--ckpt_every", "2",
         "--state_every", "1"]


def _run(cwd, *args, timeout=600):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, os.path.join(REPO, "train_torch.py"),
                           *args], cwd=str(cwd), env=env, capture_output=True,
                          text=True, timeout=timeout)


def _npz_matches_jax(path):
    """The .npz loads in the JAX package with the keys and shapes of its
    own parameters, and every value is finite."""
    import jax
    from droid_slam_tpu.models import nets as jnets
    from droid_slam_tpu.models import weights as jweights
    params = jweights.load_npz(str(path))
    ref = jnets.init_params(jax.random.PRNGKey(0))
    assert set(params) == set(ref)
    for k in ref:
        assert params[k].shape == ref[k].shape, k
        assert np.isfinite(np.asarray(params[k])).all(), k


def test_train_cli_on_the_tartanair_fixture(tmp_path):
    pytest.importorskip("cv2")
    from droid_slam_tpu_torch.data.fixtures import write_tartanair_fixture
    data = tmp_path / "TartanAir"
    write_tartanair_fixture(str(data), n_scenes=2, n_frames=10,
                            image_size=(160, 224))
    out = _run(tmp_path, "--name", "fixture", "--datasets", "tartan",
               "--datapath", str(data), "--fmin", "4.0", "--steps", "2",
               *SMALL)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    assert "step      2" in out.stdout, out.stdout[-2000:]
    ck = tmp_path / "checkpoints"
    for f in ("fixture_000002.npz", "fixture_final.npz",
              "fixture_state_final.pt"):
        assert (ck / f).is_file(), f
    _npz_matches_jax(ck / "fixture_final.npz")
    assert (data / ".index_cache" / "TartanAir.index.pkl").is_file()


def test_train_cli_synthetic_resumes_from_its_state(tmp_path):
    from droid_slam_tpu_torch.models import weights as tweights
    args = ["--name", "syn", "--datasets", "synthetic",
            "--synthetic_clips", "2", *SMALL]
    out = _run(tmp_path, *args, "--steps", "2")
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    ck = tmp_path / "checkpoints"
    _npz_matches_jax(ck / "syn_final.npz")
    params, opt_state, step, rng_state = tweights.load_train_state(
        str(ck / "syn_state_final.pt"))
    assert step == 2 and opt_state["count"] == 2 and rng_state is not None
    final = tweights.load_npz(str(ck / "syn_final.npz"))
    assert all(torch.equal(final[k], params[k]) for k in final)

    out = _run(tmp_path, *args, "--steps", "3", "--resume",
               str(ck / "syn_state_final.pt"))
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    assert "resumed" in out.stdout and "at step 2" in out.stdout
    assert "step      3" in out.stdout and "step      1" not in out.stdout
    _, opt_state, step, _ = tweights.load_train_state(
        str(ck / "syn_state_final.pt"))
    assert step == 3 and opt_state["count"] == 3


def test_train_cli_refuses_several_devices(tmp_path):
    """--devices 2 on CUDA with one card raises before any work (the
    machine's CUDA faked present with one card), as does a batch that does
    not divide over the ranks."""
    code = ("import sys, runpy, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            f"sys.argv = [{os.path.join(REPO, 'train_torch.py')!r}, "
            "'--datasets', 'synthetic', '--devices', '2']\n"
            "runpy.run_path(sys.argv[0], run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "asks for 2 CUDA devices; this machine has 1" in out.stderr
    out = _run(tmp_path, "--datasets", "synthetic", "--device", "cpu",
               "--devices", "2", "--batch", "3", timeout=120)
    assert out.returncode != 0
    assert "does not divide over 2 ranks" in out.stderr
    assert not (tmp_path / "checkpoints").exists()
