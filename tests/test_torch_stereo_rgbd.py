"""Stereo and RGB-D input through the port, against the JAX package.

Unit parity, on inputs drawn with numpy from a seed: the stereo edges'
fixed relative pose in the reprojection and its Jacobians, their zero pose
weights in the BA's linearization, one Gauss-Newton iteration with stereo
edges and one with sensor disparities (the RGB-D prior), the sensor
disparities themselves, the stereo rows of the correlation volumes and of
the alt correlation, and the stereo edge proposers.

End to end, JAX ``Droid`` and the port's ``Droid(cfg, device="cpu")`` track
the same 14 synthetic frames (64x96, ``droid_slam_tpu.data.synthetic``:
a stereo pair rendered at the rectified 0.1 baseline, or the left view with
its exact depth), with ``upsample=True`` and the bench's admit-all
thresholds, then ``terminate()`` with a filler stream. Held: equal keyframe
timestamps and edge lists (stereo: with (i, i) edges), poses and
disparities within the monocular slice's bounds (tests/test_torch_slice.py:
0.05; mean 35%; median 0.25; correlation 0.5), the full-resolution
disparities ``disps_up`` by the same median and correlation, and after
``terminate()`` an ATE against JAX's trajectory of at most 0.05 (keyframes
and filled frames, tests/test_torch_terminate.py's bound).

Readings on seeds 11-16 (run this file as a script to print them); the
graphs (keyframes and frontend edges) are equal on all twelve runs:
  stereo: poses 0.015-0.095, mean disparity 5.7-35.4%, median
    0.068-0.184, correlation >= 0.603; disps_up median 0.025-0.074,
    correlation >= 0.558 (after terminate: 0.068-0.093, >= 0.568); ATE
    keyframes 0.015-0.052, filled 0.012-0.040. Seed 11, the test's: poses
    0.028, mean 5.7%, median 0.068, correlation 0.889; disps_up 0.025 /
    0.640 (after terminate 0.073 / 0.693); ATE 0.018 and 0.012.
  rgbd: poses 0.003-0.010, mean disparity <= 0.05%, median <= 0.001,
    correlation >= 0.9996; disps_up median <= 0.0005, correlation
    >= 0.9998 (after terminate <= 0.0033, >= 0.982); ATE keyframes
    0.0009-0.032, filled 0.0008-0.022 (the largest on seed 11, the test's,
    whose second global-BA pass proposes 8 edges of 88 that JAX does not).
Stereo parts from JAX further than the monocular slice does, and on seeds
12, 13 and 15 beyond the monocular bounds (poses 0.095 and 0.068, mean
disparity 35.4%, ATE 0.052). The bounds stay the monocular ones and hold on
seed 11. What the readings show, and what they leave open:
  (1) from the same state, single steps agree: the frontend's first window
  update (stereo volumes, (i, i) BA rows) to 0.3-2.0% of its pose step
  and 0.3-0.5% in disparity on seeds 11-16
  (test_stereo_frontend_update_matches_jax_from_the_same_state), a
  stereo global-BA pass to 0.1-0.2% on seeds 11-12
  (test_stereo_backend_pass_matches_jax_from_the_same_state);
  (2) each framework against itself, with only its GRU epilogues' rounding
  changed, on seeds 11-16 (the "jax" and "port" script modes): JAX parts
  by poses 0.006-0.038, mean disparity 2.5-31.0%, median 0.027-0.107, ATE
  0.011-0.022; the port by poses 0.013-0.077, mean 3.0-17.5%, median
  0.034-0.125, ATE 0.007-0.026;
  (3) the port against JAX parts further than either against itself: its
  largest readings are 1.2-2.5x theirs in poses, 1.5-1.7x in median
  disparity and 2.0-2.4x in keyframe ATE;
  (4) with each framework run on the other's encoder outputs (the "swap"
  script mode), which differ by bf16 rounding only, the pose gap moves
  both ways (seed 12: 0.095 to 0.043 and 0.009; seed 16: 0.015 to 0.037
  and 0.020), and every swapped reading (0.009-0.069) lies within the
  frameworks' own range in (2): the gap is the rounding of every layer
  differing, amplified by the run, not one layer (ROADMAP.md §3 item 4).
  The sensor prior anchors RGB-D's disparities, so that mode agrees a
  hundred times more closely.

JAX is imported inside the tests and fixtures that use it, so that the CUDA
test runs on a machine without JAX:
    python -m pytest --noconftest -m cuda tests/test_torch_stereo_rgbd.py
"""

import os

import numpy as np
import pytest
import torch

H, W = 64, 96
N_FRAMES = 14
CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "r5_006000.npz")
CFG = dict(buffer=32, image_size=(H, W), warmup=8, frontend_window=16,
           frontend_thresh=16.0, frontend_radius=2, frontend_nms=1,
           filter_thresh=-1.0, keyframe_thresh=-1.0, upsample=True)
BACKEND_STEPS = (7, 12)
MODES = ("stereo", "rgbd")
ATE_BOUND = 0.05


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several test processes at once,
    and PyTorch's CPU kernels, each process spinning a thread per core,
    slow down many times over when they outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x)).to(dtype)


def _poses(rng, n, scale):
    import jax.numpy as jnp
    from droid_slam_tpu.lie import se3 as jse3
    xi = (scale * rng.normal(size=(n, 6))).astype(np.float32)
    return np.array(jse3.exp(jnp.asarray(xi)))


def _skip_without_checkpoint():
    if not os.path.exists(CKPT):
        pytest.skip(f"needs the trained checkpoint {CKPT}: with random "
                    "weights the two pipelines part at the first edge "
                    "proposal")


# ---------------------------------------------------------------------------
# geometry: the stereo edges' fixed baseline
# ---------------------------------------------------------------------------

def _stereo_geometry(seed, n=5, h=8, w=12):
    rng = np.random.default_rng(seed)
    poses = _poses(rng, n, scale=0.1)
    disps = rng.uniform(0.2, 2.0, size=(n, h, w)).astype(np.float32)
    intr = np.tile(np.array([[20.0, 21.0, w / 2, h / 2]], np.float32),
                   (n, 1))
    ii = np.array([0, 1, 1, 2, 3, 4, 4], np.int64)    # (1,1), (4,4) stereo
    jj = np.array([1, 0, 1, 3, 2, 0, 4], np.int64)
    return poses, disps, intr, ii, jj


def test_stereo_edges_take_the_fixed_baseline_and_its_jacobians():
    import jax.numpy as jnp
    from droid_slam_tpu.geom import projective as jproj
    from droid_slam_tpu_torch.geom import projective as tproj

    poses, disps, intr, ii, jj = _stereo_geometry(31)
    G_t = tproj.relative_poses(_t(poses), torch.as_tensor(ii),
                               torch.as_tensor(jj)).numpy()
    G_j = np.asarray(jproj.relative_poses(jnp.asarray(poses),
                                          jnp.asarray(ii), jnp.asarray(jj)))
    stereo = ii == jj
    np.testing.assert_array_equal(
        G_t[stereo], np.tile(np.float32([-0.1, 0, 0, 0, 0, 0, 1]), (2, 1)))
    np.testing.assert_allclose(G_t, G_j, atol=1e-6)

    c_j, v_j, (Ji_j, Jj_j, Jz_j) = jproj.projective_transform(
        *map(jnp.asarray, (poses, disps, intr, ii, jj)), jacobian=True,
        min_depth=0.25)
    c_t, v_t, (Ji_t, Jj_t, Jz_t) = tproj.projective_transform(
        _t(poses), _t(disps), _t(intr), torch.as_tensor(ii),
        torch.as_tensor(jj), jacobian=True, min_depth=0.25)
    # as tests/test_torch_modules.py: f32 at pixel scale
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-4)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    for got, want in ((Ji_t, Ji_j), (Jj_t, Jj_j), (Jz_t, Jz_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-3, rtol=1e-4)
    # a stereo edge moves each pixel along x only, by fx * 0.1 * d
    dx = c_t.numpy()[stereo, ..., 0] - np.arange(12)[None, None]
    np.testing.assert_allclose(dx, -2.0 * disps[ii[stereo]], atol=1e-5)


def test_frame_distance_takes_no_stereo_override():
    """The frame distance warps by poses[jj] poses[ii]^-1 on every pair:
    a pair (i, i) is at distance 0 (to f32 rounding), not at the
    baseline's ~0.1 fx d (~4 px here)."""
    from droid_slam_tpu_torch.geom import distance as tdist

    poses, disps, intr, _, _ = _stereo_geometry(32)
    i = torch.arange(5)
    d = tdist.frame_distance(_t(poses), _t(disps), _t(intr[0]), i, i, 0.3)
    assert d.abs().max() < 1e-6


def test_linearize_zeroes_the_pose_weights_of_stereo_edges():
    import jax.numpy as jnp
    from droid_slam_tpu.ba import edge_terms as jterms
    from droid_slam_tpu_torch.ba import edge_terms as tterms

    poses, disps, intr, ii, jj = _stereo_geometry(33)
    rng = np.random.default_rng(34)
    E, hw = len(ii), 8 * 12
    tgt = (rng.uniform(0, 12, size=(E, 2, hw))).astype(np.float32)
    wgt = rng.uniform(0, 1, size=(E, 2, hw)).astype(np.float32)
    want = jterms.linearize(*map(jnp.asarray, (poses, disps, intr, tgt, wgt,
                                               ii, jj)),
                            min_depth=0.25, zero_stereo_pose=True)
    got = tterms.linearize(_t(poses), _t(disps), _t(intr), _t(tgt), _t(wgt),
                           torch.as_tensor(ii), torch.as_tensor(jj))
    stereo = ii == jj
    assert (got.w_pose[stereo] == 0).all()
    assert (got.w_depth[stereo] > 0).any()
    assert torch.equal(got.w_pose[~stereo], got.w_depth[~stereo])
    for name, atol in (("r", 1e-4), ("w_pose", 1e-9), ("w_depth", 1e-9),
                       ("Jj", 1e-3), ("Jz", 1e-3), ("Adj", 1e-5)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=atol, rtol=1e-4, err_msg=name)
    # the stereo edges enter the depth blocks only
    Hii, Hij, Hji, Hjj, vi, vj = tterms.pose_blocks(got)
    Ei, Ej, Cz, bz = tterms.depth_blocks(got)
    for x in (Hii, Hij, Hji, Hjj, vi, vj, Ei, Ej):
        assert (x[stereo] == 0).all()
    assert (Cz[stereo] > 0).any()


# ---------------------------------------------------------------------------
# one Gauss-Newton iteration: stereo edges, and the sensor prior
# ---------------------------------------------------------------------------

def _ba_problem(seed, stereo_edges, sensor):
    """tests/test_torch_modules.py's windowed problem (40 keyframes, 96
    edges, free poses [2, 30), 8x12 plane), with a fifth of its edges made
    stereo, or with sensor disparities on ~70% of the pixels near the
    current ones."""
    import jax.numpy as jnp
    from droid_slam_tpu.geom import projective as jproj

    rng = np.random.default_rng(seed)
    B, h, w, E = 40, 8, 12, 96
    intr = np.array([20.0, 20.0, w / 2, h / 2], np.float32)
    ii = rng.integers(1, 30, size=E)
    jj = rng.integers(1, 30, size=E)
    jj = np.where(jj == ii, (jj % 29) + 1, jj)
    if stereo_edges:
        jj[::5] = ii[::5]
    poses = _poses(rng, B, scale=0.01)
    disps = rng.uniform(0.5, 1.5, size=(B, h, w)).astype(np.float32)
    damp = (1e-6 * np.ones((B, h, w))).astype(np.float32)
    sens = np.zeros((B, h, w), np.float32)
    if sensor:
        near = disps * rng.uniform(0.8, 1.2, size=disps.shape)
        sens = np.where(rng.uniform(size=disps.shape) < 0.7, near,
                        0.0).astype(np.float32)
    coords, _, _ = jproj.projective_transform(
        jnp.asarray(poses), jnp.asarray(disps),
        jnp.asarray(np.tile(intr, (B, 1))), jnp.asarray(ii), jnp.asarray(jj))
    tgt = (np.asarray(coords).reshape(E, h * w, 2).transpose(0, 2, 1)
           + 0.5 * rng.normal(size=(E, 2, h * w))).astype(np.float32)
    wgt = rng.uniform(0, 1, size=(E, 2, h * w)).astype(np.float32)
    return ii, jj, poses, disps, sens, damp, intr, tgt, wgt


@pytest.mark.parametrize("case", ["stereo_edges", "sensor_prior"])
def test_ba_one_gauss_newton_iteration_matches_jax(case):
    import jax.numpy as jnp
    from droid_slam_tpu.ba import inference as jba
    from droid_slam_tpu_torch.ba import inference as tba

    ii, jj, poses, disps, sens, damp, intr, tgt, wgt = _ba_problem(
        35, case == "stereo_edges", case == "sensor_prior")
    t0, t1 = 2, 30
    shape, plan = jba.build_plan(ii, jj, t0, t1, iters=1)
    E = shape.edges
    pad = lambda a: np.concatenate(
        [a, np.zeros((E - len(a),) + a.shape[1:], a.dtype)])
    want_p, want_d = jba.ba_windowed(
        shape, jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(sens),
        jnp.asarray(damp), jnp.asarray(intr), jnp.asarray(pad(tgt)),
        jnp.asarray(pad(wgt)), plan, 1e-4, 0.1)
    tplan = tba.build_plan(ii, jj, t0, t1, "cpu")
    got_p, got_d = tba.ba_iterations(
        _t(poses), _t(disps), _t(sens), _t(damp), _t(intr), _t(tgt), _t(wgt),
        tplan, lm=1e-4, ep=0.1, iters=1)
    # tests/test_torch_modules.py's tolerances for one iteration
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=2e-5)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=2e-4,
                               rtol=1e-4)
    assert np.abs(got_p.numpy() - poses).max() > 1e-4   # it did move
    # the prior changes the step: without it the disparities land elsewhere
    if case == "sensor_prior":
        _, free = tba.ba_iterations(
            _t(poses), _t(disps), torch.zeros_like(_t(sens)), _t(damp),
            _t(intr), _t(tgt), _t(wgt), tplan, lm=1e-4, ep=0.1, iters=1)
        assert (free - got_d).abs().max() > 1e-3


# ---------------------------------------------------------------------------
# the video's sensor disparities
# ---------------------------------------------------------------------------

def test_sensor_disparities_equal_jax_bit_for_bit():
    from droid_slam_tpu.state.video import DepthVideo as JVideo
    from droid_slam_tpu_torch.state.video import DepthVideo as TVideo

    rng = np.random.default_rng(36)
    depth = rng.uniform(0.3, 8.0, size=(H, W)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.2] = 0.0     # no reading
    depth[5:9, 10:30] = -1.0                             # invalid reading
    jv, tv = JVideo((H, W), 4), TVideo((H, W), 4, "cpu")
    intr = np.array([40.0, 40.0, W / 2, H / 2], np.float32)
    for k in range(2):
        jv.append(float(k), depth=depth * (k + 1), intrinsics=intr)
        tv.append(float(k), depth=depth * (k + 1), intrinsics=intr)
    got = tv.disps_sens.numpy()
    np.testing.assert_array_equal(got, np.asarray(jv.buf.disps_sens))
    assert (got[:2] == 0).any() and (got[:2] > 0).mean() > 0.5
    assert tv.disps_up is None          # no full-resolution buffer


# ---------------------------------------------------------------------------
# stereo rows: volumes, the alt correlation, the edge proposers
# ---------------------------------------------------------------------------

def _stereo_videos(seed, n=10, buffer=16):
    """A JAX and a port stereo video with the same n keyframes: poses along
    a path, disparities, and left/right features differing per view."""
    import jax.numpy as jnp
    from droid_slam_tpu.state.video import DepthVideo as JVideo
    from droid_slam_tpu_torch.state.video import DepthVideo as TVideo

    rng = np.random.default_rng(seed)
    h, w = H // 8, W // 8
    xi = np.cumsum(0.06 * rng.normal(size=(n, 6)), axis=0)
    from droid_slam_tpu.lie import se3 as jse3
    poses = np.array(jse3.exp(jnp.asarray(xi.astype(np.float32))))
    disps = rng.uniform(0.3, 1.5, size=(n, h, w)).astype(np.float32)
    fmaps = rng.normal(size=(n, 2, h, w, 128)).astype(np.float32)
    fmaps = np.asarray(jnp.asarray(fmaps, jnp.bfloat16).astype(jnp.float32))
    intr = np.array([40.0, 40.0, W / 2, H / 2], np.float32)
    jv = JVideo((H, W), buffer, stereo=True)
    tv = TVideo((H, W), buffer, "cpu", stereo=True)
    for k in range(n):
        jv.append(float(k), pose=poses[k], disp=disps[k], intrinsics=intr,
                  fmap=fmaps[k])
        tv.append(float(k), pose=_t(poses[k]), disp=_t(disps[k]),
                  intrinsics=intr,
                  fmap=_t(fmaps[k]).permute(0, 3, 1, 2).to(torch.bfloat16))
    return jv, tv, fmaps


def _edges(g):
    return list(zip(g.ii.tolist(), g.jj.tolist()))


def test_stereo_volumes_correlate_the_right_view():
    """An edge's volume correlates the left view of ii with view (ii == jj)
    of jj, as the JAX package's slot buffers hold it."""
    from droid_slam_tpu.state.graph import FactorGraph as JGraph
    from droid_slam_tpu_torch.ops import corr as tcorr
    from droid_slam_tpu_torch.state.graph import FactorGraph as TGraph

    jv, tv, _ = _stereo_videos(37)
    ii, jj = np.array([2, 3, 3, 5]), np.array([3, 3, 2, 5])
    jg, tg = JGraph(jv, None), TGraph(tv, None)
    jg.add_factors(ii, jj)
    tg.add_factors(ii, jj)
    assert _edges(tg) == _edges(jg) == list(zip(ii.tolist(), jj.tolist()))
    slots = jg._slots()
    for lvl, (tp, jp) in enumerate(zip(tg.pyramid, jg.pyramid)):
        want = np.asarray(jp[slots].astype(np.float32))
        # bf16 volumes of 128-term f32 dot products, pooled in bf16
        np.testing.assert_allclose(tp.float().numpy(), want, atol=6e-2,
                                   err_msg=f"level {lvl}")
    # the (3,3) edge's volume is not frame 3's left-left autocorrelation
    left = tv.fmaps[3:4, 0]
    auto = tcorr.build_volume(left, left).float()
    assert (tg.pyramid[0][1].float() - auto).abs().max() > 1.0


def test_alt_correlation_reads_the_stereo_rows():
    """update_lowmem's rows: source ii*c, target jj*c + (ii == jj) of the
    view-flattened feature pyramid, against JAX's alt_lookup on the same
    rows."""
    import jax.numpy as jnp
    from droid_slam_tpu.ops import corr as jcorr
    from droid_slam_tpu_torch.ops import corr as tcorr

    _, tv, fmaps = _stereo_videos(38)
    n, h, w = 10, H // 8, W // 8
    rng = np.random.default_rng(39)
    ii, jj = np.array([1, 4, 4, 7]), np.array([2, 4, 3, 7])
    coords = (rng.uniform(size=(4, h, w, 2)) * np.array([w + 4, h + 4])
              - 2).astype(np.float32)
    ii_r, jj_r = ii * 2, jj * 2 + (ii == jj)
    want = np.asarray(jcorr.alt_lookup(
        jcorr.build_fmap_pyramid(jnp.asarray(fmaps.reshape(2 * n, h, w,
                                                           128))),
        jnp.asarray(coords), jnp.asarray(ii_r), jnp.asarray(jj_r)))
    # f32 features (bf16 values): the rows are the point, not the rounding
    fpyr = tcorr.build_fmap_pyramid(
        tv.fmaps[:n].float().reshape(2 * n, 128, h, w))
    got = tcorr.alt_lookup(fpyr, _t(coords).reshape(4, h * w, 2),
                           torch.as_tensor(ii_r), torch.as_tensor(jj_r))
    # tests/test_torch_terminate.py's alt-correlation tolerance
    np.testing.assert_allclose(got.reshape(4, h, w, 196).numpy(), want,
                               atol=1e-4)


def test_stereo_neighbourhood_and_proximity_edges_equal_jax():
    """The stereo proposers give JAX's edge lists in JAX's order: the
    neighbourhood skips |i - j| <= 1, the proximity proposal adds (i, i)
    for each frame of [t0, t). Both proposers read the same distances
    (JAX's), so that the f32 distance noise cannot decide a tie."""
    import jax.numpy as jnp
    from droid_slam_tpu.state.graph import FactorGraph as JGraph
    from droid_slam_tpu_torch.state.graph import FactorGraph as TGraph

    jv, tv, _ = _stereo_videos(40)
    n = jv.counter

    def jax_distance(ii, jj, beta=0.3, bidirectional=True):
        return torch.as_tensor(np.asarray(type(jv).distance(
            jv, ii, jj, beta=beta, bidirectional=bidirectional)))

    tv.distance = jax_distance
    # the frontend's initialization, then a keyframe update
    jg, tg = JGraph(jv, None, max_factors=48), TGraph(tv, None,
                                                      max_factors=48)
    for g in (jg, tg):
        g.add_neighborhood_factors(0, 6, r=3)
    assert _edges(tg) == _edges(jg)
    assert all(abs(i - j) > 1 for i, j in _edges(tg))
    for g in (jg, tg):
        g.add_proximity_factors(0, 0, rad=2, nms=2, thresh=16.0,
                                remove=False)
    assert _edges(tg) == _edges(jg)
    for g in (jg, tg):
        g.add_proximity_factors(n - 5, max(n - 16, 0), rad=2, nms=1,
                                thresh=16.0, beta=0.3, remove=True)
    assert _edges(tg) == _edges(jg)
    inactive = lambda g: list(zip(g.ii_inac.tolist(), g.jj_inac.tolist()))
    assert inactive(tg) == inactive(jg)
    assert {(i, i) for i in range(n)} <= set(_edges(tg) + inactive(tg))
    # the global BA's proposal over all keyframes
    jg, tg = (JGraph(jv, None, corr_impl="alt", max_factors=16 * n),
              TGraph(tv, None, corr_impl="alt", max_factors=16 * n))
    for g in (jg, tg):
        g.add_proximity_factors(rad=2, nms=3, thresh=22.0, beta=0.3)
    assert _edges(tg) == _edges(jg)
    assert len(_edges(tg)) > 3 * n


# ---------------------------------------------------------------------------
# end to end: track() -> flush() -> terminate()
# ---------------------------------------------------------------------------

def _frames(mode, seed=11):
    """(tstamp, image, depth, intrinsics) per frame: a [2,H,W,3] stack in
    stereo, the left view [H,W,3] and its depth map in RGB-D."""
    from droid_slam_tpu.data.synthetic import synthetic_stream
    out = []
    for item in synthetic_stream(n_frames=N_FRAMES, image_size=(H, W),
                                 seed=seed, step=0.12, rot_step=0.04,
                                 stereo=mode == "stereo",
                                 with_depth=mode == "rgbd"):
        if mode == "rgbd":
            t, img, depth, intr = item
            out.append((float(t), img[0], depth, intr))
        else:
            t, img, intr = item
            out.append((float(t), img, None, intr))
    return out


def _filler_stream(frames):
    """tests/test_torch_terminate.py's filler stream (one frame at k + 0.5
    for every two keyframes), the stereo stacks as they are."""
    for k in range(0, len(frames), 2):
        img = frames[k if k % 4 else min(k + 1, len(frames) - 1)][1]
        yield k + 0.5, img, frames[k][3]


def _cfg(mode):
    return dict(CFG, stereo=mode == "stereo", depth=mode == "rgbd",
                weights=CKPT)


def _spy_lowmem(mp, graph_cls, edges):
    orig = graph_cls.update_lowmem

    def spy(self, *a, **k):
        edges.append(sorted(_edges(self)))
        return orig(self, *a, **k)

    mp.setattr(graph_cls, "update_lowmem", spy)


def _snapshot(buf):
    """Every video buffer, f32 (bf16 widened exactly)."""
    return {k: np.array(v, np.float32) for k, v in buf._asdict().items()}


def _run_jax(mode, frames):
    from droid_slam_tpu.config import DroidConfig
    from droid_slam_tpu.slam import Droid
    from droid_slam_tpu.slam.frontend import DroidFrontend
    from droid_slam_tpu.state.graph import FactorGraph

    droid = Droid(DroidConfig(**_cfg(mode)))
    first_update = {}
    orig = DroidFrontend.update_host

    def spy(self):
        # the video as the frontend's first window update after the
        # initialization finds it: the new keyframe at its predicted pose
        if not first_update:
            first_update.update(snap=_snapshot(self.video.buf),
                                n=self.video.counter, t1=self.t1 + 1)
        return orig(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DroidFrontend, "update_host", spy)
        for t, img, depth, intr in frames:
            droid.track(t, img, depth, intrinsics=intr)
        droid.flush()
    n, g, buf = droid.video.counter, droid.frontend.graph, droid.video.buf
    out = dict(snap=_snapshot(buf), first_update=first_update,
               params=droid.params,
               tstamps=np.asarray(buf.tstamp[:n]).tolist(),
               edges=sorted(_edges(g)), poses=np.asarray(buf.poses[:n]),
               disps=np.asarray(buf.disps[:n]),
               disps_up=np.asarray(buf.disps_up[:n]),
               disps_sens=np.asarray(buf.disps_sens[:n]))
    backend_edges = []
    with pytest.MonkeyPatch.context() as mp:
        _spy_lowmem(mp, FactorGraph, backend_edges)
        traj = droid.terminate(stream=_filler_stream(frames),
                               backend_steps=BACKEND_STEPS)
    buf = droid.video.buf
    return dict(track=out, filled=traj, backend_edges=backend_edges,
                keyframes=np.asarray(buf.poses[:n]),
                disps_up=np.asarray(buf.disps_up[:n]))


def _run_torch(mode, frames, device="cpu", fused=False):
    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.slam.droid import Droid
    from droid_slam_tpu_torch.state.graph import FactorGraph

    droid = Droid(DroidConfig(**_cfg(mode), gru_fused_epilogue=fused),
                  device=device)
    for t, img, depth, intr in frames:
        droid.track(t, img, depth, intr)
    droid.flush()
    n, g, v = droid.video.counter, droid.frontend.graph, droid.video
    # copies: terminate() writes some of these buffers in place
    snap = lambda x: x[:n].cpu().numpy().copy()
    out = dict(tstamps=v.tstamp[:n].tolist(), edges=sorted(_edges(g)),
               poses=snap(v.poses), disps=snap(v.disps),
               disps_up=snap(v.disps_up), disps_sens=snap(v.disps_sens))
    backend_edges = []
    with pytest.MonkeyPatch.context() as mp:
        _spy_lowmem(mp, FactorGraph, backend_edges)
        traj = droid.terminate(stream=_filler_stream(frames),
                               backend_steps=BACKEND_STEPS)
    return dict(track=out, filled=traj, backend_edges=backend_edges,
                stats=droid.terminate_stats,
                keyframes=v.poses[:n].cpu().numpy(),
                disps_up=v.disps_up[:n].cpu().numpy())


def _field_gaps(got, ref):
    """Largest per-frame relative gap of the mean, median over frames and
    pixels of the relative gap, least per-frame correlation."""
    g, r = (d.reshape(len(d), -1).astype(np.float64) for d in (got, ref))
    gc, rc = g - g.mean(1, keepdims=True), r - r.mean(1, keepdims=True)
    corr = (gc * rc).sum(1) / np.sqrt((gc * gc).sum(1) * (rc * rc).sum(1))
    return dict(mean=float((np.abs(g.mean(1) - r.mean(1)) / r.mean(1)).max()),
                median=float(np.median(np.abs(g - r) / r)),
                corr=float(corr.min()))


def _c2w_xyz(poses_w2c):
    from droid_slam_tpu_torch.lie import se3
    return se3.inv(torch.as_tensor(np.array(poses_w2c))).numpy()[:, :3]


def _readings(got, ref):
    from droid_slam_tpu.eval.ate import ate_rmse
    gt, rt = got["track"], ref["track"]
    return dict(
        same_backend_edges=got["backend_edges"] == ref["backend_edges"],
        pose=float(np.abs(gt["poses"] - rt["poses"]).max()),
        disps=_field_gaps(gt["disps"], rt["disps"]),
        disps_up=_field_gaps(gt["disps_up"], rt["disps_up"]),
        disps_up_terminate=_field_gaps(got["disps_up"], ref["disps_up"]),
        ate_keyframes=ate_rmse(_c2w_xyz(got["keyframes"]),
                               _c2w_xyz(ref["keyframes"]))[0],
        ate_filled=ate_rmse(got["filled"][:, :3], ref["filled"][:, :3])[0])


def _assert_same_run(got, ref, mode):
    gt, rt = got["track"], ref["track"]
    assert gt["tstamps"] == rt["tstamps"]
    assert len(rt["tstamps"]) == N_FRAMES          # every frame admitted
    assert gt["edges"] == rt["edges"]
    stereo_edges = [e for e in rt["edges"] if e[0] == e[1]]
    assert bool(stereo_edges) == (mode == "stereo")
    if mode == "rgbd":
        np.testing.assert_array_equal(gt["disps_sens"], rt["disps_sens"])
        assert (gt["disps_sens"] > 0).mean() > 0.9
    for k in ("poses", "disps", "disps_up"):
        assert np.isfinite(gt[k]).all(), k
    assert gt["disps_up"].shape == (N_FRAMES, H, W)
    assert np.isfinite(got["filled"]).all()
    assert np.isfinite(got["disps_up"]).all()

    r = _readings(got, ref)
    print(mode, r)
    assert r["pose"] <= 0.05
    assert r["disps"]["mean"] <= 0.35
    for k in ("disps", "disps_up", "disps_up_terminate"):
        assert r[k]["median"] <= 0.25, k
        assert r[k]["corr"] >= 0.5, k
    assert r["ate_keyframes"] <= ATE_BOUND
    assert r["ate_filled"] <= ATE_BOUND


def _compare(mode, got, ref):
    _assert_same_run(got, ref, mode)
    assert got["stats"]["backend_edges"] == [len(e) for e in
                                             got["backend_edges"]]


def check_track_and_terminate(mode):
    """The end-to-end comparison of one mode (RGB-D's runs in
    tests/test_torch_upsample.py, so that the two long runs go to two test
    processes)."""
    _skip_without_checkpoint()
    frames = _frames(mode)
    _compare(mode, _run_torch(mode, frames), _run_jax(mode, frames))


@pytest.fixture(scope="module")
def stereo_runs():
    _skip_without_checkpoint()
    frames = _frames("stereo")
    return dict(torch=_run_torch("stereo", frames),
                jax=_run_jax("stereo", frames))


def test_stereo_track_and_terminate_match_jax(stereo_runs):
    _compare("stereo", stereo_runs["torch"], stereo_runs["jax"])


def _stereo_videos_from(snap, n):
    """A JAX and a port stereo video holding the buffers of ``snap``."""
    import jax.numpy as jnp
    from droid_slam_tpu.state.video import DepthVideo as JVideo, VideoBuffers
    from droid_slam_tpu_torch.state.video import DepthVideo as TVideo

    B = CFG["buffer"]
    jv = JVideo((H, W), B, stereo=True)
    jv.buf = VideoBuffers(**{
        k: jnp.asarray(snap[k], jnp.bfloat16 if k in ("fmaps", "nets",
                                                      "inps")
                       else jnp.float32) for k in VideoBuffers._fields})
    jv.counter = n
    tv = TVideo((H, W), B, "cpu", stereo=True, upsample=True)
    for k in ("tstamp", "poses", "disps", "disps_sens", "disps_up",
              "intrinsics", "damping"):
        getattr(tv, k).copy_(torch.as_tensor(snap[k]))
    for k in ("nets", "inps"):
        getattr(tv, k).copy_(torch.as_tensor(snap[k]).permute(0, 3, 1, 2))
    tv.fmaps.copy_(torch.as_tensor(snap["fmaps"]).permute(0, 1, 4, 2, 3))
    tv.counter = n
    return jv, tv


def test_stereo_frontend_update_matches_jax_from_the_same_state(stereo_runs):
    """The frontend's first window update after the initialization, from
    the video JAX held then, copied into the port: the frontend's proximity
    proposal (with an (i, i) edge for each of the five newest keyframes),
    then its 3 iterations of stereo volumes, update operator and BA with
    the (i, i) rows. The edge lists are equal (both proposers read JAX's
    distances, as in the proposer test above), the pose step agrees to a
    twentieth of its size and the disparities to 2% (readings, seeds
    11-16: 0.3-2.0% of the step, 0.3-0.5% and 0.2-0.4% for ``disps`` and
    ``disps_up``)."""
    from droid_slam_tpu.state.graph import FactorGraph as JGraph
    from droid_slam_tpu_torch.models import weights as tweights
    from droid_slam_tpu_torch.state.graph import FactorGraph as TGraph

    r = _frontend_update_readings(stereo_runs["jax"]["track"],
                                  tweights.load(CKPT, "cpu"), JGraph, TGraph)
    print("stereo frontend update", r)
    assert r["stereo_edges"] == 5
    assert r["moved"] > 1e-2
    assert r["gap"] <= 0.05 * r["moved"]
    assert r["disp"] <= 0.02 and r["disps_up"] <= 0.02


def _frontend_update_readings(ref, tparams, JGraph, TGraph):
    first = ref["first_update"]
    snap, n, t1 = first["snap"], first["n"], first["t1"]
    assert t1 == n == CFG["warmup"] + 1
    jv, tv = _stereo_videos_from(snap, n)
    tv.distance = lambda ii, jj, beta=0.3, bidirectional=True: (
        torch.as_tensor(np.array(type(jv).distance(
            jv, ii, jj, beta=beta, bidirectional=bidirectional))))
    jg = JGraph(jv, ref["params"], max_factors=48, upsample=True)
    tg = TGraph(tv, tparams, max_factors=48, upsample=True)
    for g in (jg, tg):
        g.add_proximity_factors(
            t1 - 5, max(t1 - CFG["frontend_window"], 0),
            rad=CFG["frontend_radius"], nms=CFG["frontend_nms"],
            thresh=CFG["frontend_thresh"], beta=0.3, remove=True)
    assert _edges(tg) == _edges(jg)
    jg.update(None, None, use_inactive=True, n_iters=3)
    tg.update(None, None, use_inactive=True, n_iters=3)
    jp = np.asarray(jv.buf.poses[:n])
    rel = lambda a, b: float(np.median(np.abs(a - b) / b))
    return dict(
        stereo_edges=sum(i == j for i, j in _edges(jg)),
        moved=float(np.abs(jp - snap["poses"][:n]).max()),
        gap=float(np.abs(tv.poses[:n].numpy() - jp).max()),
        disp=rel(tv.disps[:n].numpy(), np.asarray(jv.buf.disps[:n])),
        disps_up=rel(tv.disps_up[:n].numpy(),
                     np.asarray(jv.buf.disps_up[:n])))


def test_stereo_backend_pass_matches_jax_from_the_same_state(stereo_runs):
    """One global-BA pass (no normalization in stereo, proximity edges with
    (i, i), update_lowmem over the view-flattened rows with one step and
    upsampling) from JAX's post-tracking state copied into the port: the
    same edges, and a pose step that agrees to a fiftieth of its size
    (readings, seeds 11 and 12: 0.1% and 0.2%)."""
    from droid_slam_tpu.config import DroidConfig as JConfig
    from droid_slam_tpu.slam.backend import DroidBackend as JBackend
    from droid_slam_tpu.state.graph import FactorGraph as JGraph
    from droid_slam_tpu_torch.config import DroidConfig as TConfig
    from droid_slam_tpu_torch.models import weights as tweights
    from droid_slam_tpu_torch.slam.backend import DroidBackend as TBackend
    from droid_slam_tpu_torch.state.graph import FactorGraph as TGraph

    ref = stereo_runs["jax"]["track"]
    snap, n = ref["snap"], len(ref["tstamps"])
    jv, tv = _stereo_videos_from(snap, n)
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        for key, cls in (("jax", JGraph), ("torch", TGraph)):
            _spy_lowmem(mp, cls, seen.setdefault(key, []))
        JBackend(ref["params"], jv,
                 JConfig(**_cfg("stereo")))(steps=1)
        TBackend(tweights.load(CKPT, "cpu"), tv,
                 TConfig(**_cfg("stereo")))(steps=1)
    assert seen["torch"] == seen["jax"] and len(seen["jax"]) == 1
    assert any(i == j for i, j in seen["jax"][0])
    jp = np.asarray(jv.buf.poses[:n])
    moved = np.abs(jp - snap["poses"][:n]).max()
    gap = np.abs(tv.poses[:n].numpy() - jp).max()
    rel = lambda a, b: float(np.median(np.abs(a - b) / b))
    dgap = rel(tv.disps[:n].numpy(), np.asarray(jv.buf.disps[:n]))
    ugap = rel(tv.disps_up[:n].numpy(), np.asarray(jv.buf.disps_up[:n]))
    print("stereo backend pass", dict(moved=moved, gap=gap, disp=dgap,
                                      disps_up=ugap))
    assert moved > 1e-2
    assert gap <= 0.02 * moved
    assert dgap <= 0.01 and ugap <= 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_track_and_terminate_on_cuda_match_cpu(mode):
    """The port on the GPU (CUDA lookup kernel on every edge, the stereo
    edges' included, cuDNN, cuSOLVER) against the port on the CPU, within
    the bounds held against JAX (tests/test_torch_terminate.py's
    test_terminate_on_cuda_matches_cpu)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    _skip_without_checkpoint()
    from droid_slam_tpu_torch.ops import corr_cuda
    fr = _frames(mode)        # numpy only: no JAX needed
    before = corr_cuda.LAUNCHES
    got = _run_torch(mode, fr, device="cuda")
    assert corr_cuda.LAUNCHES > before
    _assert_same_run(got, _run_torch(mode, fr), mode)


def _run_jax_interpret(mode, seed):
    """_run_jax with the JAX package's Pallas GRU epilogues in interpret
    mode, in a process of its own (JAX reads DROID_GRU_PALLAS once, at
    import): JAX against itself with only the epilogues' rounding
    changed."""
    import pickle
    import subprocess
    import sys
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "run.pkl")
        code = ("import sys, pickle\n"
                f"sys.path.insert(0, {os.path.dirname(__file__)!r})\n"
                "import test_torch_stereo_rgbd as s\n"
                f"r = s._run_jax({mode!r}, s._frames({mode!r}, {seed}))\n"
                "r['track'].pop('params')\n"
                f"pickle.dump(r, open({out!r}, 'wb'))\n")
        env = dict(os.environ, DROID_GRU_PALLAS="interpret",
                   JAX_PLATFORMS="cpu")
        proc = subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True, timeout=1800)
        assert proc.returncode == 0, proc.stderr[-3000:]
        with open(out, "rb") as f:
            return pickle.load(f)


def _features_patch(mp, video_cls, port, record=None, feats=None):
    """Patch ``video_cls.set_frame`` (the port's when ``port``, else JAX's)
    to record each keyframe's encoder outputs (fmap, net, inp), keyed by
    timestamp, in JAX's layout as f32 numpy into ``record``, or to write
    those of ``feats`` in their place: the layer-swap diagnostic."""
    import inspect

    import jax.numpy as jnp
    orig = video_cls.set_frame
    sig = inspect.signature(orig)

    def to_jax(name, x):
        x = torch.as_tensor(x).float() if port else np.asarray(x, np.float32)
        if port:
            x = x.movedim(-3, -1).numpy()
        return np.array(x, np.float32)

    def from_jax(name, x):
        if port:
            return torch.as_tensor(x).movedim(-1, -3).to(torch.bfloat16)
        return jnp.asarray(x, jnp.bfloat16)

    def set_frame(*a, **k):
        b = sig.bind(*a, **k)
        b.apply_defaults()
        t = float(b.arguments["tstamp"])
        if all(b.arguments[n] is not None for n in ("fmap", "net", "inp")):
            if record is not None:
                record[t] = {n: to_jax(n, b.arguments[n])
                             for n in ("fmap", "net", "inp")}
            if feats is not None and t in feats:
                for n in ("fmap", "net", "inp"):
                    b.arguments[n] = from_jax(n, feats[t][n])
        return orig(*b.args, **b.kwargs)

    mp.setattr(video_cls, "set_frame", set_frame)


def _layer_swap(mode, frames):
    """The layer-swap diagnostic: each framework's run, recording its
    encoders' outputs, then each run again with the other's outputs
    written in their place. Returns the readings of the port against JAX
    as they are, with JAX's features in the port, and with the port's in
    JAX, and the features' own largest gaps."""
    from droid_slam_tpu.state.video import DepthVideo as JVideo
    from droid_slam_tpu_torch.state.video import DepthVideo as TVideo

    jf, tf = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        _features_patch(mp, JVideo, False, record=jf)
        jax_run = _run_jax(mode, frames)
    with pytest.MonkeyPatch.context() as mp:
        _features_patch(mp, TVideo, True, record=tf)
        port_run = _run_torch(mode, frames)
    with pytest.MonkeyPatch.context() as mp:
        _features_patch(mp, TVideo, True, feats=jf)
        port_jf = _run_torch(mode, frames)
    with pytest.MonkeyPatch.context() as mp:
        _features_patch(mp, JVideo, False, feats=tf)
        jax_tf = _run_jax(mode, frames)
    gaps = {n: float(max(np.abs(jf[t][n] - tf[t][n]).max() for t in jf))
            for n in ("fmap", "net", "inp")}
    out = {"features_max_gap": gaps}
    for what, got, ref in (("port-vs-jax", port_run, jax_run),
                           ("port+jax-features-vs-jax", port_jf, jax_run),
                           ("jax+port-features-vs-port", jax_tf, port_run)):
        same = (got["track"]["tstamps"] == ref["track"]["tstamps"]
                and got["track"]["edges"] == ref["track"]["edges"])
        out[what] = _readings(got, ref) if same else "graphs differ"
    return out


if __name__ == "__main__":
    # The readings behind the docstring, on other scenes:
    #   PYTHONPATH=. JAX_PLATFORMS=cpu \
    #       python tests/test_torch_stereo_rgbd.py 11 12 [stereo|rgbd] \
    #           [jax|port]
    # prints the port against JAX, and in stereo the frontend update from
    # the same state. Each framework against itself with only its GRU
    # epilogues' rounding changed: "jax", JAX with its Pallas epilogues in
    # interpret mode against JAX default; "port", the port's fused
    # epilogues against its default. "swap": the layer-swap diagnostic
    # (``_layer_swap``), each framework run on the other's encoder
    # outputs.
    import sys
    from droid_slam_tpu.state.graph import FactorGraph as JGraph
    from droid_slam_tpu_torch.models import weights as tweights
    from droid_slam_tpu_torch.state.graph import FactorGraph as TGraph
    args = sys.argv[1:]
    for seed in [int(a) for a in args if a.isdigit()] or [11]:
        for mode in [a for a in args if a in MODES] or MODES:
            fr = _frames(mode, seed)
            if "swap" in args:
                print(seed, mode, "swap", _layer_swap(mode, fr), flush=True)
                continue
            if "jax" in args:
                ref = _run_jax(mode, fr)
                got, what = _run_jax_interpret(mode, seed), "jax-interpret"
            elif "port" in args:
                ref = _run_torch(mode, fr)
                got, what = _run_torch(mode, fr, fused=True), "port-fused"
            else:
                ref = _run_jax(mode, fr)
                got, what = _run_torch(mode, fr), "port"
            same = (got["track"]["tstamps"] == ref["track"]["tstamps"]
                    and got["track"]["edges"] == ref["track"]["edges"])
            print(seed, mode, what,
                  f"keyframes {len(ref['track']['tstamps'])}",
                  "same graph" if same else "graphs differ",
                  _readings(got, ref) if same else "", flush=True)
            if mode == "stereo" and what == "port":
                r = _frontend_update_readings(
                    ref["track"], tweights.load(CKPT, "cpu"), JGraph, TGraph)
                print(seed, "stereo frontend update", r, flush=True)
