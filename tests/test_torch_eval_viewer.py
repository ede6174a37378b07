"""The port's reconstruction export and viewer core against the JAX package:
``reconstruction_point_cloud``, ``merge_videos``, ``build_scene``,
``transform_segments``, ``render_offscreen`` and the PNG of
``save_screenshot``, on one video state made from a numpy seed: a port
``DepthVideo`` on the CPU, handed to JAX as a ``SimpleNamespace`` with the
same buffers (as ``tests/test_viewer.py`` builds its videos).

Tolerances: the depth filter's counts, and so the masks, colours and point
counts, agree exactly (the scene's depths sit away from the thresholds);
points to f32 rounding (POINT_ATOL); the merged poses and disparities to
MERGE_ATOL (the alignment's SE3 mean runs a log/exp chain in f32 in both);
the rendered image from one scene bit for bit (the same numpy code).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from droid_slam_tpu_torch.eval import viewer as tviewer
from droid_slam_tpu_torch.eval import visualization as tvis
from droid_slam_tpu_torch.lie import se3 as tse3
from droid_slam_tpu_torch.state.video import DepthVideo

B, T, H, W = 14, 10, 12, 16          # buffer, keyframes, feature plane
POINT_ATOL = 1e-5
MERGE_ATOL = 1e-5


def _video(seed=0, t=T, scale=1.0, images=True):
    """A keyframe video on the CPU: poses along +x with small rotations,
    disparities near 1 (a wall in front of the cameras), 8x images."""
    rng = np.random.default_rng(seed)
    v = DepthVideo((8 * H, 8 * W), B, "cpu")
    xi = np.zeros((t, 6), np.float32)
    xi[:, 0] = 0.05 * np.arange(t)
    xi[:, 3:] = 0.005 * rng.normal(size=(t, 3))
    poses = tse3.exp(torch.as_tensor(xi))
    poses[:, :3] *= scale
    disps = (0.9 + 0.1 * rng.uniform(size=(t, H, W))) / scale
    for k in range(t):
        img = (rng.integers(0, 255, (8 * H, 8 * W, 3)).astype(np.uint8)
               if images else None)
        v.set_frame(k, float(k), pose=poses[k],
                    disp=torch.as_tensor(disps[k], dtype=torch.float32),
                    intrinsics=[16.0 * 8, 16.0 * 8, 8.0 * 8, 6.0 * 8],
                    image=img)
    return v


def _jax_video(v):
    """The JAX package's view of the same state (whole buffers)."""
    import jax.numpy as jnp
    buf = SimpleNamespace(poses=jnp.asarray(v.poses.numpy()),
                          disps=jnp.asarray(v.disps.numpy()),
                          intrinsics=jnp.asarray(v.intrinsics.numpy()))
    return SimpleNamespace(counter=v.counter, buf=buf, h=v.h, w=v.w,
                           buffer=v.buffer, images=list(v.images))


@pytest.mark.parametrize("stride", [1, 2])
def test_reconstruction_point_cloud_matches_jax(stride):
    from droid_slam_tpu.eval import visualization as jvis

    v = _video()
    pts, cols = tvis.reconstruction_point_cloud(v, filter_thresh=0.02,
                                                stride=stride)
    jpts, jcols = jvis.reconstruction_point_cloud(
        _jax_video(v), filter_thresh=0.02, stride=stride)
    assert pts.dtype == np.float32 and cols.dtype == np.uint8
    assert 0 < len(pts) < len(range(0, T, stride)) * H * W
    assert pts.shape == jpts.shape and cols.shape == jcols.shape
    np.testing.assert_array_equal(cols, jcols)
    np.testing.assert_allclose(pts, jpts, rtol=0, atol=POINT_ATOL)


def test_point_cloud_without_images_is_black():
    v = _video(images=False)
    pts, cols = tvis.reconstruction_point_cloud(v, filter_thresh=0.02)
    assert len(pts) and not cols.any()


def test_transform_segments_matches_jax():
    from droid_slam_tpu.eval import viewer as jviewer

    poses = _video().poses[:T].numpy()
    segs = tviewer.frustum_segments()
    np.testing.assert_allclose(tviewer.transform_segments(poses, segs),
                               jviewer.transform_segments(poses, segs),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("t_back", [0, 4, T, T + 2])
def test_merge_videos_matches_jax(t_back):
    """The backend's video at 2x scale: none, shorter than the tracker's
    (the tail aligned into it), as long, longer (authoritative)."""
    from droid_slam_tpu.eval import viewer as jviewer

    front = _video(seed=1)
    back = None if t_back == 0 else _video(seed=1, t=t_back, scale=2.0)
    poses, disps = tviewer.merge_videos(front, back)
    jposes, jdisps = jviewer.merge_videos(
        _jax_video(front), None if back is None else _jax_video(back))
    n = max(T, t_back)
    assert poses.shape == (n, 7) and disps.shape == (n, H, W)
    np.testing.assert_allclose(poses, jposes, rtol=0, atol=MERGE_ATOL)
    np.testing.assert_allclose(disps, jdisps, rtol=0, atol=MERGE_ATOL)
    if t_back == 4:   # the tail lands on the backend's 2x trajectory
        np.testing.assert_allclose(poses[4:, :3],
                                   2.0 * front.poses[4:T, :3].numpy(),
                                   atol=1e-4)


def test_build_scene_matches_jax():
    from droid_slam_tpu.eval import viewer as jviewer

    v = _video(seed=2)
    scene = tviewer.build_scene(v)
    ref = jviewer.build_scene(_jax_video(v))
    for name in ("colors", "alpha"):
        np.testing.assert_array_equal(getattr(scene, name),
                                      getattr(ref, name))
    np.testing.assert_allclose(scene.points, ref.points, rtol=0,
                               atol=POINT_ATOL)
    np.testing.assert_allclose(scene.cam_segments, ref.cam_segments,
                               rtol=0, atol=1e-6)
    assert 0.05 < scene.alpha.mean() < 1.0
    assert tviewer.build_scene(_video(t=3)) is None


def test_render_offscreen_matches_jax_bit_for_bit():
    from droid_slam_tpu.eval import viewer as jviewer

    scene = tviewer.build_scene(_video(seed=3))
    img = tviewer.render_offscreen(scene, size=(120, 160))
    ref = jviewer.render_offscreen(scene, size=(120, 160))
    assert img.shape == (120, 160, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(img, ref)
    background = (np.array([0.09, 0.09, 0.10]) * 255).astype(np.uint8)
    assert (img != background).any(axis=-1).mean() > 0.01


def test_save_screenshot_writes_the_render_as_png(tmp_path):
    """The PNG (zlib and struct, no cv2) decodes with cv2 to the render."""
    cv2 = pytest.importorskip("cv2")
    v = _video(seed=4)
    path = tmp_path / "shot.png"
    assert tviewer.save_screenshot(path, v, size=(90, 120))
    got = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    want = tviewer.render_offscreen(tviewer.build_scene(v), size=(90, 120))
    np.testing.assert_array_equal(got[..., ::-1], want)
    assert not tviewer.save_screenshot(tmp_path / "none.png", _video(t=3))
    assert not (tmp_path / "none.png").exists()
