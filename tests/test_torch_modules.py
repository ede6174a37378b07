"""The PyTorch port's modules against the JAX package on the same inputs.

Inputs are drawn with numpy from a seed and handed to both frameworks;
parameters come from ``checkpoints/r5_006000.npz`` (the JAX package's seeded
random init when the file is absent) through ``from_jax_params``. Every
comparison here runs in f32, where the point is the algorithm; the stated
tolerances cover f32 reassociation (different summation orders in XLA's
and PyTorch's CPU kernels), grown by the depth of each computation.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from droid_slam_tpu.ba import inference as jba
from droid_slam_tpu.geom import distance as jdist
from droid_slam_tpu.geom import projective as jproj
from droid_slam_tpu.lie import se3 as jse3
from droid_slam_tpu.models import nets as jnets

from droid_slam_tpu_torch.ba import inference as tba
from droid_slam_tpu_torch.geom import distance as tdist
from droid_slam_tpu_torch.geom import projective as tproj
from droid_slam_tpu_torch.lie import se3 as tse3
from droid_slam_tpu_torch.models import nets as tnets
from droid_slam_tpu_torch.models import weights as tweights

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "r5_006000.npz")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several test processes at once,
    and PyTorch's CPU kernels, each process spinning a thread per core,
    slow down many times over when they outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    if os.path.exists(CKPT):
        with np.load(CKPT) as d:
            return {k: d[k] for k in d.files}
    import jax
    return {k: np.asarray(v)
            for k, v in jnets.init_params(jax.random.PRNGKey(0)).items()}


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return tweights.from_jax_params(jax_params)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x)).to(dtype)


def _poses(rng, n, scale=0.3):
    xi = (scale * rng.normal(size=(n, 6))).astype(np.float32)
    return np.array(jse3.exp(jnp.asarray(xi)))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def test_from_jax_params_roundtrips_every_tensor_exactly(jax_params):
    state = tweights.from_jax_params(jax_params)
    assert set(state) == set(jax_params)
    conv = jax_params["update.gru.convz.weight"]          # HWIO
    assert tuple(state["update.gru.convz.weight"].shape) == (
        conv.shape[3], conv.shape[2], conv.shape[0], conv.shape[1])
    back = tweights.to_jax_params(state)
    for k, v in jax_params.items():
        assert back[k].shape == v.shape and back[k].dtype == np.float32, k
        assert np.array_equal(back[k], v), k


def test_init_params_has_the_checkpoint_shapes(jax_params):
    init = tweights.init_params(0)
    # the checkpoint and the seeded init describe the same network
    assert set(init) == set(tweights.from_jax_params(jax_params))
    for k, v in tweights.from_jax_params(jax_params).items():
        assert init[k].shape == v.shape, k


# ---------------------------------------------------------------------------
# SE3 (tolerance 1e-5: f32 transcendental functions of both libraries)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["exp", "log", "inv", "mul", "act", "retr",
                                "adjT", "adj_matrix", "normalize"])
def test_se3_matches_jax(op):
    rng = np.random.default_rng(3)
    xi = (0.5 * rng.normal(size=(64, 6))).astype(np.float32)
    xi[:4] *= 1e-5                        # small-angle branches
    g = np.asarray(jse3.exp(jnp.asarray(xi)))
    h = _poses(rng, 64)
    X = rng.normal(size=(64, 4)).astype(np.float32)
    a = rng.normal(size=(64, 6)).astype(np.float32)
    args = {"exp": (xi,), "log": (g,), "inv": (g,), "mul": (g, h),
            "act": (g, X), "retr": (g, xi), "adjT": (g, a),
            "adj_matrix": (g,), "normalize": (1.3 * g,)}[op]
    expect = np.asarray(getattr(jse3, op)(*map(jnp.asarray, args)))
    got = getattr(tse3, op)(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, expect, atol=1e-5, rtol=1e-5)


def test_se3_identity():
    np.testing.assert_array_equal(tse3.identity((3,)).numpy(),
                                  np.asarray(jse3.identity((3,))))


# ---------------------------------------------------------------------------
# projective geometry and frame distance
# ---------------------------------------------------------------------------

def _geometry(rng, n=5, h=8, w=12):
    poses = _poses(rng, n, scale=0.1)
    disps = rng.uniform(0.2, 2.0, size=(n, h, w)).astype(np.float32)
    intr = np.tile(np.array([[20.0, 21.0, w / 2, h / 2]], np.float32),
                   (n, 1))
    ii = np.array([0, 1, 2, 3, 4, 1], np.int64)
    jj = np.array([1, 0, 3, 2, 0, 4], np.int64)
    return poses, disps, intr, ii, jj


def test_projective_transform_and_jacobians_match_jax():
    poses, disps, intr, ii, jj = _geometry(np.random.default_rng(4))
    c_j, v_j, (Ji_j, Jj_j, Jz_j) = jproj.projective_transform(
        *map(jnp.asarray, (poses, disps, intr, ii, jj)), jacobian=True,
        min_depth=0.25)
    c_t, v_t, (Ji_t, Jj_t, Jz_t) = tproj.projective_transform(
        _t(poses), _t(disps), _t(intr), torch.as_tensor(ii),
        torch.as_tensor(jj), jacobian=True, min_depth=0.25)
    # pixel coordinates (~10-100): 1e-4 absolute is f32 at that scale
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-4)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    for got, want in ((Ji_t, Ji_j), (Jj_t, Jj_j), (Jz_t, Jz_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-3, rtol=1e-4)


def test_frame_distance_matches_jax():
    poses, disps, intr, ii, jj = _geometry(np.random.default_rng(5))
    # one pair far behind the camera exercises the 1000.0 branch
    poses[4, 2] = -50.0
    for bidir in (True, False):
        want = np.asarray(jdist.frame_distance(
            *map(jnp.asarray, (poses, disps, intr[0], ii, jj)), 0.3,
            bidirectional=bidir))
        got = tdist.frame_distance(_t(poses), _t(disps), _t(intr[0]),
                                   torch.as_tensor(ii), torch.as_tensor(jj),
                                   0.3, bidirectional=bidir).numpy()
        assert (want >= 500.0).any()   # a 1000.0 direction is averaged in
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# networks (f32; tolerances relative to the activations' scale)
# ---------------------------------------------------------------------------

def _nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


def test_extract_features_matches_jax(jax_params, torch_params):
    rng = np.random.default_rng(6)
    img = rng.integers(0, 255, size=(2, 64, 96, 3)).astype(np.uint8)
    want = jnets.extract_features(
        {k: jnp.asarray(v) for k, v in jax_params.items()}, jnp.asarray(img))
    got = tnets.extract_features(torch_params, torch.as_tensor(img))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == (2, 128, 8, 12)
        # 9 conv layers deep with instance norms: 1e-3 of the activations
        np.testing.assert_allclose(_nhwc(g), w, atol=1e-3 * np.abs(w).max())


def test_extract_features_stereo_left_context_matches_jax(jax_params,
                                                          torch_params):
    """The motion filter's encoder on a stereo stack: fnet on both views,
    cnet on the left one only (JAX's ``motion_filter.py`` encodes
    ``images_bgr[:1]`` for the context)."""
    rng = np.random.default_rng(16)
    img = rng.integers(0, 255, size=(2, 64, 96, 3)).astype(np.uint8)
    jp = {k: jnp.asarray(v) for k, v in jax_params.items()}
    want_fmap = jnets.extract_features(jp, jnp.asarray(img))[0]
    _, want_net, want_inp = jnets.extract_features(jp, jnp.asarray(img[:1]))
    fmap, net, inp = tnets.extract_features(
        torch_params, torch.as_tensor(img), cnet_views=1)
    assert fmap.shape == (2, 128, 8, 12)
    assert net.shape == inp.shape == (1, 128, 8, 12)
    for g, w in ((fmap, want_fmap), (net, want_net), (inp, want_inp)):
        w = np.asarray(w)
        # test_extract_features_matches_jax's tolerance
        np.testing.assert_allclose(_nhwc(g), w, atol=1e-3 * np.abs(w).max())


@pytest.mark.parametrize("with_pre", [False, True])
def test_update_module_matches_jax(jax_params, torch_params, with_pre):
    rng = np.random.default_rng(7)
    E, h, w = 3, 8, 12
    net = np.tanh(rng.normal(size=(E, h, w, 128))).astype(np.float32)
    inp = np.maximum(rng.normal(size=(E, h, w, 128)), 0).astype(np.float32)
    corr = rng.normal(size=(E, h, w, 196)).astype(np.float32)
    flow = rng.normal(size=(E, h, w, 4)).astype(np.float32)
    ii = np.array([0, 1, 1])
    jp = {k: jnp.asarray(v) for k, v in jax_params.items()}
    pre_j = jnets.gru_context_pre(jp, jnp.asarray(inp)) if with_pre else None
    want = jnets.update_module(
        jp, jnp.asarray(net), None if with_pre else jnp.asarray(inp),
        jnp.asarray(corr), jnp.asarray(flow), ii=jnp.asarray(ii),
        num_frames=2, pre=pre_j, compute_upmask=False)

    nchw = lambda a: torch.as_tensor(a).permute(0, 3, 1, 2).contiguous()
    pre_t = (tnets.gru_context_pre(torch_params, nchw(inp))
             if with_pre else None)
    got = tnets.update_module(
        torch_params, nchw(net), None if with_pre else nchw(inp),
        nchw(corr), nchw(flow), ii=torch.as_tensor(ii), num_frames=2,
        pre=pre_t)
    for g, w_ in zip(got[:3], want[:3]):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(_nhwc(g), w_,
                                   atol=1e-4 * max(np.abs(w_).max(), 1.0))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               atol=1e-6, rtol=1e-4)


# ---------------------------------------------------------------------------
# windowed BA: one Gauss-Newton iteration at the bench plan's shape
# (bench.py: 32-frame window, 96 edges, t0=2, t1=30), on 8x12 images
# ---------------------------------------------------------------------------

def _ba_problem(seed):
    rng = np.random.default_rng(seed)
    B, h, w, E = 40, 8, 12, 96
    intr = np.array([20.0, 20.0, w / 2, h / 2], np.float32)
    ii = rng.integers(1, 30, size=E)
    jj = rng.integers(1, 30, size=E)
    jj = np.where(jj == ii, (jj % 29) + 1, jj)
    jj = np.where(jj == ii, (ii % 29) + 1, jj)
    poses = _poses(rng, B, scale=0.01)
    disps = rng.uniform(0.5, 1.5, size=(B, h, w)).astype(np.float32)
    damp = (1e-6 * np.ones((B, h, w))).astype(np.float32)
    # targets: the current reprojection plus ~0.5 px of noise, so that one
    # Gauss-Newton step is a small, well-conditioned correction
    coords, _, _ = jproj.projective_transform(
        jnp.asarray(poses), jnp.asarray(disps),
        jnp.asarray(np.tile(intr, (B, 1))), jnp.asarray(ii), jnp.asarray(jj))
    tgt = (np.asarray(coords).reshape(E, h * w, 2).transpose(0, 2, 1)
           + 0.5 * rng.normal(size=(E, 2, h * w))).astype(np.float32)
    wgt = rng.uniform(0, 1, size=(E, 2, h * w)).astype(np.float32)
    return ii, jj, poses, disps, damp, intr, tgt, wgt


@pytest.mark.parametrize("motion_only", [False, True])
def test_ba_one_gauss_newton_iteration_matches_jax(motion_only):
    ii, jj, poses, disps, damp, intr, tgt, wgt = _ba_problem(8)
    t0, t1 = 2, 30
    shape, plan = jba.build_plan(ii, jj, t0, t1, iters=1,
                                 motion_only=motion_only)
    E = shape.edges
    pad = lambda a: np.concatenate(
        [a, np.zeros((E - len(a),) + a.shape[1:], a.dtype)])
    want_p, want_d = jba.ba_windowed(
        shape, jnp.asarray(poses), jnp.asarray(disps),
        jnp.zeros_like(jnp.asarray(disps)), jnp.asarray(damp),
        jnp.asarray(intr), jnp.asarray(pad(tgt)), jnp.asarray(pad(wgt)),
        plan, 1e-4, 0.1)
    tplan = tba.build_plan(ii, jj, t0, t1, "cpu")
    got_p, got_d = tba.ba_iterations(
        _t(poses), _t(disps), torch.zeros_like(_t(disps)), _t(damp),
        _t(intr), _t(tgt), _t(wgt), tplan,
        lm=1e-4, ep=0.1, iters=1, motion_only=motion_only)
    # the step itself is compared: the update moves poses by ~1e-2 and
    # disparities by ~1e-1, and f32 Cholesky solves of the Schur system
    # agree to ~1e-5 of that
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=2e-5)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=2e-4,
                               rtol=1e-4)
    assert np.abs(got_p.numpy() - poses).max() > 1e-4   # it did move


def test_ba_motion_only_returns_before_the_finite_step_guard():
    """The JAX package's motion-only path returns before the non-finite
    step guard (ba/inference.py:365-370); the port keeps that: a residual
    that is not finite poisons the motion-only step, while the full BA
    drops the step and keeps the previous iterate."""
    ii, jj, poses, disps, damp, intr, tgt, wgt = _ba_problem(9)
    tgt[0, 0, 0] = np.inf       # finite Hessian, non-finite right-hand side
    t0, t1 = 2, 30
    plan = tba.build_plan(ii, jj, t0, t1, "cpu")
    out = {}
    for mo in (True, False):
        shape, jplan = jba.build_plan(ii, jj, t0, t1, iters=1,
                                      motion_only=mo)
        E = shape.edges
        pad = lambda a: np.concatenate(
            [a, np.zeros((E - len(a),) + a.shape[1:], a.dtype)])
        jp, _ = jba.ba_windowed(
            shape, jnp.asarray(poses), jnp.asarray(disps),
            jnp.zeros_like(jnp.asarray(disps)), jnp.asarray(damp),
            jnp.asarray(intr), jnp.asarray(pad(tgt)), jnp.asarray(pad(wgt)),
            jplan, 1e-4, 0.1)
        tp, td = tba.ba_iterations(_t(poses), _t(disps),
                                   torch.zeros_like(_t(disps)), _t(damp),
                                   _t(intr), _t(tgt), _t(wgt), plan, iters=1,
                                   motion_only=mo)
        out[mo] = (np.asarray(jp), tp.numpy(), td.numpy())
    jp, tp, _ = out[True]
    assert not np.isfinite(jp).all() and not np.isfinite(tp).all()
    jp, tp, td = out[False]
    np.testing.assert_array_equal(jp, poses)
    np.testing.assert_array_equal(tp, poses)
    assert np.isfinite(td).all()


def test_video_normalize_and_reproject_match_jax():
    from droid_slam_tpu.state.video import DepthVideo as JVideo
    from droid_slam_tpu_torch.state.video import DepthVideo as TVideo

    rng = np.random.default_rng(10)
    n, B = 5, 8
    poses = _poses(rng, n, scale=0.1)
    disps = rng.uniform(0.2, 2.0, size=(n, 8, 12)).astype(np.float32)
    intr = np.array([20.0, 21.0, 6.0, 4.0], np.float32)
    jv, tv = JVideo((64, 96), B), TVideo((64, 96), B, "cpu")
    for k in range(n):
        jv.append(float(k), pose=poses[k], disp=disps[k], intrinsics=intr)
        tv.append(float(k), pose=_t(poses[k]), disp=_t(disps[k]),
                  intrinsics=intr)
    ii, jj = np.array([0, 1, 3]), np.array([2, 0, 4])
    (jc, jval), (tc, tval) = jv.reproject(ii, jj), tv.reproject(ii, jj)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4)
    np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))

    jv.normalize()
    tv.normalize()
    # one f32 mean over n*h*w disparities, then a division: 1e-6 relative
    np.testing.assert_allclose(tv.disps[:B].numpy(),
                               np.asarray(jv.buf.disps), rtol=1e-5)
    np.testing.assert_allclose(tv.poses[:B].numpy(),
                               np.asarray(jv.buf.poses), rtol=1e-5,
                               atol=1e-7)
