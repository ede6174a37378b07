"""The port's reconstruction geometry against the JAX package: ``se3.act3``,
``geom/filters.py``'s ``depth_filter`` and ``iproj_points``.

Inputs are made with numpy from seeds. The depth filter's counts are small
integers from threshold tests, so they must agree exactly on scenes whose
depths sit away from the thresholds (random disparities in [0.8, 1.2] and
thresholds of 5% of the mean); the points agree to f32 rounding (1e-6
relative to the largest coordinate).
"""

import numpy as np
import pytest
import torch

from droid_slam_tpu_torch.geom import filters as tfilters
from droid_slam_tpu_torch.lie import se3 as tse3

N, H, W = 9, 12, 16
INTR = np.array([16.0, 16.0, 8.0, 6.0], np.float32)
POINT_RTOL = 1e-6


def _poses(rng, n, step=0.05, rot=0.01):
    from droid_slam_tpu.lie import se3 as jse3
    import jax.numpy as jnp

    xi = np.zeros((n, 6), np.float32)
    xi[:, 0] = step * np.arange(n)
    xi[:, 3:] = rot * rng.normal(size=(n, 3))
    return np.array(jse3.exp(jnp.asarray(xi)))


def _jax_filter(poses, disps, intr, inds, thresh):
    import jax.numpy as jnp
    from droid_slam_tpu.geom import filters as jfilters
    return np.asarray(jfilters.depth_filter(
        jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(intr),
        jnp.asarray(inds), jnp.asarray(thresh)))


def _torch_filter(poses, disps, intr, inds, thresh):
    t = torch.as_tensor
    return tfilters.depth_filter(t(poses), t(disps), t(intr), t(inds),
                                 t(thresh)).numpy()


def test_act3_matches_jax():
    import jax.numpy as jnp
    from droid_slam_tpu.lie import se3 as jse3

    rng = np.random.default_rng(0)
    g = _poses(rng, 5, step=0.3, rot=0.5)
    x = rng.normal(size=(5, 7, 3)).astype(np.float32)
    want = np.asarray(jse3.act3(jnp.asarray(g)[:, None], jnp.asarray(x)))
    got = tse3.act3(torch.as_tensor(g)[:, None], torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [1, 2])
def test_depth_filter_matches_jax(seed):
    """Every frame queried, the first and the last included: their
    neighbours outside [0, N) count 0 in both."""
    rng = np.random.default_rng(seed)
    poses = _poses(rng, N)
    disps = (0.8 + 0.4 * rng.uniform(size=(N, H, W))).astype(np.float32)
    inds = np.arange(N)
    thresh = (0.05 * disps.mean(axis=(1, 2))).astype(np.float32)
    want = _jax_filter(poses, disps, INTR, inds, thresh)
    got = _torch_filter(poses, disps, INTR, inds, thresh)
    assert got.shape == (N, H, W) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # counts spread over 0..6, the end frames at most 3 (three neighbours
    # exist for frame 0, and three before the last)
    assert len(np.unique(got)) >= 4
    assert got[0].max() <= 3 and got[-1].max() <= 3


def test_depth_filter_neighbour_map_is_minus_three_to_plus_five():
    """All frames at the identity pose: a pixel warps onto itself, so a
    neighbour confirms it exactly when their disparities match. Every frame
    k has its own disparity 1 + 0.5 k but for two plants: frame 8 takes
    frame 3's and frame 6 frame 5's. Under the map [-1,-2,-3,3,4,5] frame 3
    is confirmed once (by 3+5), frame 5 never (5+1 is not asked), frame 6
    once (by 6-1); frames 0 and 8 never. The last column and row never
    count (u0 < w-1, v0 < h-1)."""
    poses = np.tile([0, 0, 0, 0, 0, 0, 1.0], (N, 1)).astype(np.float32)
    disps = np.stack([np.full((H, W), 1.0 + 0.5 * k, np.float32)
                      for k in range(N)])
    disps[8] = disps[3]
    disps[6] = disps[5]
    inds = np.array([3, 5, 6, 0, N - 1])
    thresh = np.full(len(inds), 0.01, np.float32)
    want = _jax_filter(poses, disps, INTR, inds, thresh)
    got = _torch_filter(poses, disps, INTR, inds, thresh)
    np.testing.assert_array_equal(got, want)
    inner = (slice(None, H - 1), slice(None, W - 1))
    assert (got[0][inner] == 1).all()       # frame 3: only 3+5 confirms
    assert (got[1] == 0).all()              # frame 5: 5+1 is not asked
    assert (got[2][inner] == 1).all()       # frame 6: 6-1 confirms
    assert (got[3:] == 0).all()
    assert (got[:, H - 1] == 0).all() and (got[:, :, W - 1] == 0).all()


def test_depth_filter_zero_disparities_and_far_warps_match_jax():
    """Zero disparities (1e-8 before the reciprocal) and poses that carry
    most pixels outside their neighbours' images."""
    rng = np.random.default_rng(3)
    poses = _poses(rng, N, step=0.6, rot=0.3)
    disps = (0.8 + 0.4 * rng.uniform(size=(N, H, W))).astype(np.float32)
    disps[:, ::3, ::4] = 0.0
    inds = np.array([0, 4, 8])
    thresh = np.full(3, 0.05, np.float32)
    got = _torch_filter(poses, disps, INTR, inds, thresh)
    np.testing.assert_array_equal(
        got, _jax_filter(poses, disps, INTR, inds, thresh))


def test_iproj_points_match_jax():
    import jax.numpy as jnp
    from droid_slam_tpu.geom import filters as jfilters

    rng = np.random.default_rng(4)
    poses = _poses(rng, N, step=0.2, rot=0.2)
    disps = (0.2 + rng.uniform(size=(N, H, W))).astype(np.float32)
    disps[0, 0, 0] = 0.0                     # the 1e-8 floor
    want = np.asarray(jfilters.iproj_points(
        jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(INTR)))
    got = tfilters.iproj_points(torch.as_tensor(poses),
                                torch.as_tensor(disps),
                                torch.as_tensor(INTR)).numpy()
    assert got.shape == (N, H, W, 3)
    finite = np.isfinite(want).all(axis=-1)
    finite[0, 0, 0] = False                  # 1e8-sized, compared relative
    np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                               atol=POINT_RTOL * np.abs(want[finite]).max())
    np.testing.assert_allclose(got[0, 0, 0], want[0, 0, 0], rtol=1e-6)
