"""The port's BA row table and its Schur assembly against the JAX package.

The port assembles the Schur complement from the JAX package's row table
(one row per window frame, one per edge, grouped by depth frame), so its
cost is linear in the edges. Held here:
  * the table itself against ``droid_slam_tpu/ba/inference.py::_build_rows``
    with JAX's padding (bucketed window and edge counts, -1 fill) stripped;
  * the assembled S and S_rhs against the dense sum over depth frames of
    E_k Q_k E_k^T, written out in the test;
  * one Gauss-Newton iteration at a global-BA window (260 frames, JAX's
    ``big_nw`` path with its flat pose grid and looped Schur chunks), full
    and motion-only, at the tolerances of the frontend-window test in
    ``test_torch_modules.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from droid_slam_tpu.ba import inference as jba
from droid_slam_tpu.geom import projective as jproj
from droid_slam_tpu.lie import se3 as jse3

from droid_slam_tpu_torch.ba import inference as tba


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _frontend_edges(rng):
    """A frontend-like window: 96 edges among frames [1, 30), free poses
    [2, 30) (the bench plan's shape)."""
    ii = rng.integers(1, 30, size=96)
    jj = rng.integers(1, 30, size=96)
    jj = np.where(jj == ii, (ii % 29) + 1, jj)
    return ii, jj, 2, 30


def _global_edges(rng, t=260, per_frame=4):
    """A global-BA graph: each frame linked to ``per_frame`` frames at most
    3 apart, both directions; free poses [1, t)."""
    ii = np.repeat(np.arange(t), per_frame // 2)
    off = rng.integers(1, 4, size=len(ii))
    jj = np.where(ii + off < t, ii + off, ii - off)
    return np.concatenate([ii, jj]), np.concatenate([jj, ii]), 1, t


@pytest.mark.parametrize("graph", ["frontend", "global"])
def test_row_table_matches_jax(graph):
    rng = np.random.default_rng(20)
    ii, jj, t0, t1 = (_frontend_edges if graph == "frontend"
                      else _global_edges)(rng)
    shape, jplan = jba.build_plan(ii, jj, t0, t1, iters=1)
    plan = tba.build_plan(ii, jj, t0, t1, "cpu")
    NW, E = plan.k_valid.shape[0], len(ii)
    NWp = shape.window
    assert NW == t1 - int(jplan.g0) and NWp >= NW and shape.edges >= E

    # JAX rows [0, NW) and [NWp, NWp+E) are the port's [0, NW) and [NW, NW+E)
    to_port = lambda r: np.where(r < NWp, r, r - NWp + NW)
    jrows = np.concatenate([np.arange(NW), NWp + np.arange(E)])
    np.testing.assert_array_equal(plan.k_valid.numpy(),
                                  np.asarray(jplan.k_valid)[:NW])
    np.testing.assert_array_equal(plan.row_pose.numpy(),
                                  np.asarray(jplan.row_pose)[jrows])
    np.testing.assert_array_equal(plan.row_depth.numpy(),
                                  np.asarray(jplan.row_depth)[jrows])
    jrk = np.asarray(jplan.rk_idx)
    assert not (jrk[NW:] >= 0).any()       # padded window frames: no rows
    rk = plan.rk_idx.numpy()
    assert rk.shape[1] == max((jrk[:NW] >= 0).sum(1).max(), 1)
    for k in range(NW):
        want = sorted(to_port(jrk[k][jrk[k] >= 0]).tolist())
        got = rk[k][rk[k] >= 0].tolist()
        assert got == sorted(got) and got == want, k


def _problem(rng, ii, jj, B, h, w):
    """Poses near the identity, disparities around 1, targets at the
    current reprojection plus ~0.5 px of noise, random weights."""
    E = len(ii)
    intr = np.array([20.0, 20.0, w / 2, h / 2], np.float32)
    xi = (0.01 * rng.normal(size=(B, 6))).astype(np.float32)
    poses = np.array(jse3.exp(jnp.asarray(xi)))
    disps = rng.uniform(0.5, 1.5, size=(B, h, w)).astype(np.float32)
    damp = (1e-6 * np.ones((B, h, w))).astype(np.float32)
    coords, _, _ = jproj.projective_transform(
        jnp.asarray(poses), jnp.asarray(disps),
        jnp.asarray(np.tile(intr, (B, 1))), jnp.asarray(ii), jnp.asarray(jj))
    tgt = (np.asarray(coords).reshape(E, h * w, 2).transpose(0, 2, 1)
           + 0.5 * rng.normal(size=(E, 2, h * w))).astype(np.float32)
    wgt = rng.uniform(0, 1, size=(E, 2, h * w)).astype(np.float32)
    return poses, disps, damp, intr, tgt, wgt


def test_schur_rows_equal_the_dense_sum():
    """S and S_rhs from the row groups equal sum_k E_k Q_k E_k^T and
    sum_k E_k Q_k w_k, with E_k [6P, HW] the coupling of depth frame k with
    every free pose (the form the row table replaces), in f64."""
    rng = np.random.default_rng(21)
    ii, jj, t0, t1 = _frontend_edges(rng)
    plan = tba.build_plan(ii, jj, t0, t1, "cpu")
    NW, P, hw, E = plan.k_valid.shape[0], t1 - t0, 12, len(ii)
    g = lambda *s: torch.as_tensor(rng.normal(size=s))
    Ei, Ej, Q, qw = g(E, 6, hw), g(E, 6, hw), g(NW, hw).abs(), g(NW, hw)
    ki = plan.ii - plan.g0
    S, S_rhs, _ = tba._schur(Ei, Ej, Q, qw, ki, plan, P)

    Ek = torch.zeros((NW, P + 1, 6, hw), dtype=torch.float64)
    for e in range(E):
        for f, blk in ((ii[e], Ei[e]), (jj[e], Ej[e])):
            p = f - t0 if t0 <= f < t1 else P
            Ek[ki[e], p] += blk
    Ek = Ek[:, :P].reshape(NW, 6 * P, hw)
    want_S = torch.einsum("krh,kh,ksh->rs", Ek, Q, Ek)
    want_rhs = torch.einsum("krh,kh->r", Ek, qw)
    torch.testing.assert_close(S, want_S, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(S_rhs, want_rhs, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("motion_only", [False, True])
def test_global_window_gauss_newton_iteration_matches_jax(motion_only):
    """One GN iteration over a 260-frame window (JAX pads it to 264, so its
    NW >= 256 path runs) at a 4x6 plane, 4 edges per frame."""
    rng = np.random.default_rng(22)
    t = 260
    ii, jj, t0, t1 = _global_edges(rng, t=t)
    poses, disps, damp, intr, tgt, wgt = _problem(rng, ii, jj, t + 4, 4, 6)
    shape, jplan = jba.build_plan(ii, jj, t0, t1, iters=1,
                                  motion_only=motion_only, window=264)
    assert shape.window >= jba._BIG_NW
    E = shape.edges
    pad = lambda a: np.concatenate(
        [a, np.zeros((E - len(a),) + a.shape[1:], a.dtype)])
    want_p, want_d = jba.ba_windowed(
        shape, jnp.asarray(poses), jnp.asarray(disps),
        jnp.zeros_like(jnp.asarray(disps)), jnp.asarray(damp),
        jnp.asarray(intr), jnp.asarray(pad(tgt)), jnp.asarray(pad(wgt)),
        jplan, 1e-4, 0.1)
    t_ = lambda a: torch.as_tensor(a)
    plan = tba.build_plan(ii, jj, t0, t1, "cpu")
    got_p, got_d = tba.ba_iterations(
        t_(poses), t_(disps), torch.zeros_like(t_(disps)), t_(damp),
        t_(intr), t_(tgt), t_(wgt), plan,
        lm=1e-4, ep=0.1, iters=1, motion_only=motion_only)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=2e-5)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=2e-4,
                               rtol=1e-4)
    assert np.abs(got_p.numpy() - poses).max() > 1e-4   # it did move
