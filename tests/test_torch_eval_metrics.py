"""The port's numpy evaluation pieces against the JAX package: the KITTI
metrics, the relative pose error, and the EuRoC, TUM and ETH3D streams.

The metrics are the same numpy code on the same inputs, so they agree
exactly. The streams read the fixtures that ``data/fixtures.py`` writes in
each dataset's layout, and must give the same frames bit for bit (they
skip without cv2, which reads the images).
"""

import numpy as np
import pytest
import torch

from droid_slam_tpu_torch.eval import ate as tate
from droid_slam_tpu_torch.eval import kitti as tkitti


def _trajectories(seed, n=150, step=8.0):
    """A ground-truth walk of ~n*step m (c2w [t,q]) and a noisy estimate."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    t = np.cumsum(step * (0.5 + rng.uniform(size=(n, 3))), axis=0)
    q = Rotation.from_rotvec(np.cumsum(0.02 * rng.normal(size=(n, 3)),
                                       axis=0)).as_quat()
    gt = np.concatenate([t, q], axis=1)
    est = gt.copy()
    est[:, :3] += 0.5 * rng.normal(size=(n, 3))
    est[:, 3:] = (Rotation.from_quat(q)
                  * Rotation.from_rotvec(0.01 * rng.normal(size=(n, 3)))
                  ).as_quat()
    return gt, est


@pytest.mark.parametrize("step", [5, 10])
def test_kitti_metrics_equal_jax(step):
    from droid_slam_tpu.eval import kitti as jkitti

    gt, est = _trajectories(0)
    got = tkitti.kitti_sequence_errors(gt, est, step=step)
    want = jkitti.kitti_sequence_errors(gt, est, step=step)
    assert len(got) == len(want) > 10
    assert got == want
    assert tkitti.kitti_metrics(gt, est, step) == \
        jkitti.kitti_metrics(gt, est, step)
    # a sequence shorter than every length scores (0, 0)
    assert tkitti.kitti_metrics(gt[:3], est[:3]) == (0.0, 0.0)


@pytest.mark.parametrize("delta", [1, 3])
def test_rpe_equals_jax(delta):
    from droid_slam_tpu.eval import ate as jate

    gt, est = _trajectories(1, n=40, step=0.3)
    for a, b in zip(tate.rpe_pairs(est, gt, delta),
                    jate.rpe_pairs(est, gt, delta)):
        np.testing.assert_array_equal(a, b)
    assert tate.rpe(est, gt, delta) == jate.rpe(est, gt, delta)
    t, r = tate.rpe(gt, gt, delta)
    assert t < 1e-9 and r < 1e-6


def _frames_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stereo", [False, True])
def test_euroc_stream_equals_jax(tmp_path, stereo):
    pytest.importorskip("cv2")
    from droid_slam_tpu.data import stream as jstream
    from droid_slam_tpu_torch.data import fixtures, stream as tstream

    fixtures.write_euroc_fixture(str(tmp_path), n_frames=4, stereo=stereo)
    kw = dict(image_size=(64, 96), stereo=stereo)
    _frames_equal(tstream.euroc_stream(str(tmp_path), **kw),
                  jstream.euroc_stream(str(tmp_path), **kw))
    np.testing.assert_array_equal(tstream.euroc_timestamps(str(tmp_path)),
                                  jstream.euroc_timestamps(str(tmp_path)))


def test_tum_stream_equals_jax(tmp_path):
    pytest.importorskip("cv2")
    from droid_slam_tpu.data import stream as jstream
    from droid_slam_tpu_torch.data import fixtures, stream as tstream

    fixtures.write_tum_fixture(str(tmp_path), n_frames=5)
    for stride in (1, 2):
        kw = dict(stride=stride, image_size=(64, 96))
        _frames_equal(tstream.tum_stream(str(tmp_path), **kw),
                      jstream.tum_stream(str(tmp_path), **kw))
        np.testing.assert_array_equal(
            tstream.tum_timestamps(str(tmp_path), stride),
            jstream.tum_timestamps(str(tmp_path), stride))


@pytest.mark.parametrize("use_depth", [False, True])
def test_eth3d_stream_equals_jax(tmp_path, use_depth):
    pytest.importorskip("cv2")
    from droid_slam_tpu.data import stream as jstream
    from droid_slam_tpu_torch.data import fixtures, stream as tstream

    fixtures.write_eth3d_fixture(str(tmp_path), n_frames=4)
    kw = dict(use_depth=use_depth, target_area=96 * 128)
    _frames_equal(list(tstream.eth3d_stream(str(tmp_path), **kw)),
                  list(jstream.eth3d_stream(str(tmp_path), **kw)))
    np.testing.assert_array_equal(tstream.eth3d_timestamps(str(tmp_path)),
                                  jstream.eth3d_timestamps(str(tmp_path)))


@pytest.mark.parametrize("mode", ["mono", "stereo_depth"])
def test_synthetic_stream_in_threads_gives_the_same_frames(mode):
    """The evaluation renders its frames in threads (``workers``): the same
    frames, bit for bit, in the same order as the serial stream."""
    from droid_slam_tpu_torch.data.synthetic import synthetic_stream

    kw = dict(n_frames=5, image_size=(32, 48), seed=3,
              stereo=mode != "mono", with_depth=mode != "mono")
    _frames_equal(list(synthetic_stream(**kw, workers=3)),
                  list(synthetic_stream(**kw)))
