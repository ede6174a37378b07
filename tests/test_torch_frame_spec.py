"""The port's frame path against JAX's, part 2: decisions and speculation.

  * tests/test_torch_slice.py's reject-and-drop configuration (a frame
    rejected, keyframes dropped) on its 14 frames at 64x96, strict-frame
    and speculative, against JAX's frame path (``DROID_FUSED_FRAME=1``,
    ``DROID_SPEC_FRAME=0/1``): equal keyframes, edges and
    mis-speculations, poses and disparities within the slice test's
    bounds.
  * The speculation against the strict-frame pipeline of the port itself,
    as tests/test_spec_frame.py holds JAX's: with a proximity threshold
    below every distance the proposal does not depend on distances, so the
    one intended difference of speculation (distances probed one update
    earlier) drops out, and the two must agree to float tolerance across
    the three outcomes of a speculated frame: commit (every frame admitted
    and kept), admission rejection (unwound, no re-run) and keyframe
    removal (unwound and run again with forced gates).
    The threshold is -1, where JAX's test takes 0: a distance can be
    exactly 0. Part A of a frame that ran no update (its previous frame
    was rejected) applies no motion model, so its probe two frames ahead
    reads a frame the video has not predicted yet, at the identity pose,
    and that frame's distance to frame 0 (also at the identity) is 0. JAX's
    frame program does the same (droid_slam_tpu/slam/fused_frame.py:
    153-172); with the port's seeded random weights the rejection case
    below meets it (a pair (6, 0) proposed at threshold 0 under
    speculation only).

Run as a script to track the synthetic evaluation scene (seed 7, 120
frames, the tartanair preset: ``evaluation_scripts/test_synthetic.py`` and
its port) with JAX's speculative frame path and the port's, on the CPU, and
print both frame by frame (the keyframe counter after each frame, each
frame's keyframe distances taken by ``finalize``), then the keyframes,
mis-speculations and ATE of each (ROADMAP.md §3 item 16; ~25 min at
160x256):
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_frame_spec.py 160 256
"""

import numpy as np
import pytest
import torch

import test_torch_frame as frame_test

H, W = 64, 96


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_reject_and_drop():
    frame_test._need_checkpoint()
    frames = frame_test.mono_frames()
    cfg = frame_test.mono_cfg("reject_and_drop")
    return {"strict_frame": frame_test.run_jax(cfg, frames, False),
            "spec": frame_test.run_jax(cfg, frames, True)}


@pytest.mark.parametrize("mode", ["strict_frame", "spec"])
def test_reject_and_drop_matches_jax(jax_reject_and_drop, mode):
    ref = jax_reject_and_drop[mode]
    got = frame_test.run_torch(frame_test.mono_cfg("reject_and_drop"),
                               frame_test.mono_frames(), mode == "spec")
    frame_test.assert_same_track(got, ref, "reject_and_drop")
    if mode == "spec":
        assert got["mis"] >= 1 and got["reruns"] >= 1   # both were taken


# ---------------------------------------------------------------------------
# speculation against the strict-frame pipeline (the port alone)
# ---------------------------------------------------------------------------

def _stream(n=16, seed=0):
    """tests/test_spec_frame.py's stream: a noise texture rolled 3 px a
    frame."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, size=(H, W, 3)).astype(np.uint8)
    return [(float(t), np.roll(base, shift=3 * t, axis=1), None,
             np.array([40.0, 40.0, W / 2, H / 2], np.float32))
            for t in range(n)]


def _run(spec, filter_thresh=-1.0, keyframe_thresh=-1.0, n=16):
    """The port with seeded random weights, as tests/test_spec_frame.py
    runs JAX."""
    cfg = dict(buffer=32, image_size=(H, W), warmup=5,
               filter_thresh=filter_thresh, keyframe_thresh=keyframe_thresh,
               frontend_window=10, frontend_thresh=-1.0)
    return frame_test.run_torch(cfg, _stream(n), spec)


def _assert_consistent(strict, spec):
    assert strict["droid"].video.counter == spec["droid"].video.counter
    assert strict["droid"].filterx.count == spec["droid"].filterx.count
    assert strict["edges"] == spec["edges"]
    assert np.isfinite(spec["poses"]).all()
    np.testing.assert_allclose(spec["poses"], strict["poses"], atol=1e-4)


def test_spec_commits_as_strict_frame():
    strict, spec = _run(False), _run(True)
    assert spec["mis"] == 0 and spec["droid"].video.counter == 16
    _assert_consistent(strict, spec)


def test_spec_unwinds_rejected_frames_as_strict_frame():
    """A threshold at the median admission delta of the all-admit run
    rejects about half the frames after the warm-up."""
    thr = float(np.median(_run(False)["droid"]._delta_log))
    strict, spec = _run(False, filter_thresh=thr), \
        _run(True, filter_thresh=thr)
    assert spec["droid"].video.counter < 16
    assert spec["mis"] >= 1 and spec["reruns"] == 0
    _assert_consistent(strict, spec)


def test_spec_reruns_after_keyframe_removal_as_strict_frame():
    strict = _run(False, keyframe_thresh=1e9, n=10)
    spec = _run(True, keyframe_thresh=1e9, n=10)
    assert spec["droid"].video.counter <= 8
    assert spec["mis"] >= 1 and spec["reruns"] >= 1
    _assert_consistent(strict, spec)


def _track_evaluation_scene(which, h, w, n_frames=120, seed=7):
    """The synthetic evaluation scene on JAX's (``which`` "jax") or the
    port's speculative frame path, on the CPU: (per frame [keyframe
    counter, the distances its finalize calls took], keyframes,
    mis-speculations, ATE)."""
    import dataclasses
    import os

    kw = dict(n_frames=n_frames, image_size=(h, w), seed=seed, step=0.10,
              rot_step=0.03)
    if which == "jax":
        os.environ["DROID_FUSED_FRAME"] = os.environ["DROID_SPEC_FRAME"] = "1"
        from droid_slam_tpu.config import PRESETS
        from droid_slam_tpu.data.synthetic import (synthetic_groundtruth,
                                                   synthetic_stream)
        from droid_slam_tpu.eval.ate import evaluate_ate
        from droid_slam_tpu.slam import Droid
        droid = Droid(dataclasses.replace(
            PRESETS["tartanair"], weights=frame_test.CKPT,
            image_size=(h, w), buffer=256, filter_thresh=1.75))
        frames = list(synthetic_stream(**kw))
    else:
        from droid_slam_tpu_torch.config import PRESETS
        from droid_slam_tpu_torch.data.synthetic import (
            synthetic_groundtruth, synthetic_stream)
        from droid_slam_tpu_torch.eval.ate import evaluate_ate
        from droid_slam_tpu_torch.slam.droid import Droid
        droid = Droid(dataclasses.replace(
            PRESETS["tartanair"], weights=frame_test.CKPT,
            image_size=(h, w), buffer=256, filter_thresh=1.75,
            fused_frame=True, spec_frame=True), device="cpu")
        frames = list(synthetic_stream(**kw, workers=4))
    taken, finalize = [], droid.frontend.finalize

    def logged(kf_value=None):
        taken.append(kf_value)
        return finalize(kf_value=kf_value)

    droid.frontend.finalize = logged
    rows = []
    for t, image, intrinsics in frames:
        taken.clear()
        droid.track(float(t), image, intrinsics=intrinsics)
        rows.append([int(droid.video.counter),
                     [None if d is None else round(float(d), 4)
                      for d in taken]])
    n = int(droid.video.counter)
    traj = droid.terminate(iter(frames), backend_steps=(7, 12))
    ate = evaluate_ate(traj[:, :3], synthetic_groundtruth(**kw)[:, :3],
                       scale=True)["ate_rmse"]
    mis = getattr(droid, "spec_mis", getattr(droid, "_spec_mis", 0))
    return rows, n, mis, float(ate)


if __name__ == "__main__":
    import sys

    torch.set_num_threads(4)
    h, w = (int(a) for a in sys.argv[1:3])
    runs = {k: _track_evaluation_scene(k, h, w) for k in ("jax", "torch")}
    (jr, *jrest), (tr, *trest) = runs["jax"], runs["torch"]
    for k, (a, b) in enumerate(zip(jr, tr)):
        print(k, "jax", a, "port", b)
    differ = [k for k, (a, b) in enumerate(zip(jr, tr)) if a[0] != b[0]]
    print(dict(size=[h, w], first_counter_difference=(differ or [None])[0],
               jax=dict(zip(("keyframes", "mis", "ate"), jrest)),
               port=dict(zip(("keyframes", "mis", "ate"), trest))))
