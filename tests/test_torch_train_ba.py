"""The training slice's geometry against the JAX package: Sim(3), the
reprojection map and induced flow, the differentiable dense BA (values and
gradients), the solver's gradient on an indefinite system, and the
update operator's gradient clip.

Inputs are drawn with numpy from a seed and handed to both frameworks as
arrays. Bounds (each reading is printed by ``python
tests/test_torch_train_ba.py``):
  * sim3 and the geometry: 1e-5 absolute (f32 of values of size ~1-10;
    readings 1e-7 to 2e-6);
  * dense BA and motion-only BA on ``tests/test_ba_dense.py``'s scene,
    three steps: poses 1e-4, disparities 1e-4 (readings below 1e-6);
    padded edges inert to 1e-6, as the JAX package's own test holds;
  * the gradient of a scalar of one BA step with respect to target and
    weight against ``jax.grad``: relative error 1e-3 (readings ~1e-6).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from droid_slam_tpu.ba import dense as jdense
from droid_slam_tpu.ba.solver import solve_psd as jsolve
from droid_slam_tpu.geom import projective as jproj
from droid_slam_tpu.lie import se3 as jse3
from droid_slam_tpu.lie import sim3 as jsim3
from droid_slam_tpu.models import layers as jlayers

from droid_slam_tpu_torch.ba import dense as tdense
from droid_slam_tpu_torch.ba.solver import solve_psd as tsolve
from droid_slam_tpu_torch.geom import projective as tproj
from droid_slam_tpu_torch.lie import sim3 as tsim3
from droid_slam_tpu_torch.models import layers as tlayers

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_ba_dense import synthetic_problem  # noqa: E402

GEOM_TOL = 1e-5
BA_TOL = 1e-4
GRAD_REL_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.array(x))


def _gap(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


# ---------------------------------------------------------------------------
# Sim(3)
# ---------------------------------------------------------------------------

def _sim3_tangents(rng, n=64):
    """Generic tangents, then the small-sigma, small-theta and both-small
    branches of the W coefficients."""
    xi = rng.normal(size=(n, 7)).astype(np.float32)
    xi[:, 3:6] *= 0.8
    xi[:, 6] *= 0.3
    xi[n // 4:n // 2, 6] = rng.normal(size=n // 4) * 1e-7
    xi[n // 2:3 * n // 4, 3:6] = rng.normal(size=(n // 4, 3)) * 1e-6
    xi[3 * n // 4:, 3:7] = rng.normal(size=(n - 3 * n // 4, 4)) * 1e-7
    return xi


def sim3_readings(seed=0):
    rng = np.random.default_rng(seed)
    xa, xb = _sim3_tangents(rng), _sim3_tangents(rng)
    X = rng.normal(size=(64, 4)).astype(np.float32)
    ja, jb = jsim3.exp(jnp.asarray(xa)), jsim3.exp(jnp.asarray(xb))
    ta, tb = tsim3.exp(_t(xa)), tsim3.exp(_t(xb))
    g7 = np.asarray(jse3.exp(jnp.asarray(xa[:, :6])))
    s = rng.uniform(0.5, 2.0, size=64).astype(np.float32)
    return {
        "exp": _gap(ja, ta),
        "log": _gap(jsim3.log(ja), tsim3.log(ta)),
        "mul": _gap(jsim3.mul(ja, jb), tsim3.mul(ta, tb)),
        "inv": _gap(jsim3.inv(ja), tsim3.inv(ta)),
        "act": _gap(jsim3.act(ja, jnp.asarray(X)), tsim3.act(ta, _t(X))),
        "scale": _gap(jsim3.scale(ja, jnp.asarray(s)),
                      tsim3.scale(ta, _t(s))),
        "from_se3": _gap(jsim3.from_se3(jnp.asarray(g7)),
                         tsim3.from_se3(_t(g7))),
        "to_se3": _gap(jsim3.to_se3(ja), tsim3.to_se3(ta)),
        "identity": _gap(jsim3.identity((3,)), tsim3.identity((3,))),
        "log_exp_roundtrip": _gap(tsim3.log(ta), xa),
    }


def test_sim3_matches_jax_on_every_branch():
    r = sim3_readings()
    for k, v in r.items():
        bound = 1e-4 if k == "log_exp_roundtrip" else GEOM_TOL
        assert v < bound, (k, v)


# ---------------------------------------------------------------------------
# projmap, induced_flow
# ---------------------------------------------------------------------------

def _geometry_scene(rng, n=4, h=12, w=16):
    # large motions and near points, so that some points land behind
    # MIN_DEPTH_BA and some behind the projmap's z = 0.01 fallback
    xi = rng.normal(size=(n, 6)).astype(np.float32)
    poses = np.asarray(jse3.exp(jnp.asarray(xi)))
    disps = rng.uniform(0.05, 3.0, size=(n, h, w)).astype(np.float32)
    intr = np.tile(np.array([20.0, 20.0, w / 2, h / 2], np.float32), (n, 1))
    ii = np.array([a for a in range(n) for b in range(n) if a != b])
    jj = np.array([b for a in range(n) for b in range(n) if a != b])
    return poses, disps, intr, ii, jj


def geometry_readings(seed=1):
    rng = np.random.default_rng(seed)
    args = _geometry_scene(rng)
    jargs = [jnp.asarray(a) for a in args]
    targs = [_t(a) for a in args]
    jc, jv = jproj.projmap(*jargs)
    tc, tv = tproj.projmap(*targs)
    jf, jfv = jproj.induced_flow(*jargs)
    tf, tfv = tproj.induced_flow(*targs)
    return {"projmap": _gap(jc, tc), "projmap_valid": _gap(jv, tv),
            "projmap_valid_share": float(np.mean(np.asarray(jv))),
            "induced_flow": _gap(jf, tf), "induced_flow_valid": _gap(jfv, tfv)}


def test_projmap_and_induced_flow_match_jax():
    r = geometry_readings()
    assert 0.2 < r["projmap_valid_share"] < 1.0   # both sides of the test
    for k in ("projmap", "projmap_valid", "induced_flow",
              "induced_flow_valid"):
        assert r[k] < GEOM_TOL, (k, r[k])


# ---------------------------------------------------------------------------
# dense BA
# ---------------------------------------------------------------------------

def _ba_scene(seed=42):
    rng = np.random.default_rng(seed)
    (poses_gt, disps_gt, poses0, disps0, intr, ii, jj,
     target) = synthetic_problem(rng)
    n, h, w = disps_gt.shape
    E = ii.shape[0]
    weight = (0.5 + 0.5 * rng.uniform(size=(E, 2, h * w))).astype(np.float32)
    eta = (0.01 + 0.02 * rng.uniform(size=(n, h * w))).astype(np.float32)
    return {k: np.asarray(v) for k, v in dict(
        poses_gt=poses_gt, disps_gt=disps_gt, poses0=poses0, disps0=disps0,
        intr=intr, ii=ii, jj=jj, target=target, weight=weight,
        eta=eta).items()}


def ba_readings(seed=42, steps=3):
    s = _ba_scene(seed)
    J = {k: jnp.asarray(v)[None] for k, v in s.items()
         if k not in ("ii", "jj")}
    T = {k: _t(v)[None] for k, v in s.items() if k not in ("ii", "jj")}
    ii, jj = s["ii"], s["jj"]
    jp, jd = J["poses0"], J["disps0"]
    tp, td = T["poses0"], T["disps0"]
    jm, tm = J["poses0"], T["poses0"]
    for _ in range(steps):
        jp, jd = jdense.bundle_adjust(J["target"], J["weight"], J["eta"], jp,
                                      jd, J["intr"], jnp.asarray(ii),
                                      jnp.asarray(jj), fixedp=2)
        tp, td = tdense.bundle_adjust(T["target"], T["weight"], T["eta"], tp,
                                      td, T["intr"], _t(ii), _t(jj), fixedp=2)
        jm = jdense.motion_only(J["target"], J["weight"], jm, J["disps_gt"],
                                J["intr"], jnp.asarray(ii), jnp.asarray(jj),
                                fixedp=2)
        tm = tdense.motion_only(T["target"], T["weight"], tm, T["disps_gt"],
                                T["intr"], _t(ii), _t(jj), fixedp=2)
    moved = _gap(jp, J["poses0"])
    return {"ba_poses": _gap(jp, tp), "ba_disps": _gap(jd, td),
            "motion_only_poses": _gap(jm, tm), "poses_moved": moved}


def test_dense_ba_and_motion_only_match_jax():
    r = ba_readings()
    assert r["poses_moved"] > 1e-2        # the steps did work
    assert r["ba_poses"] < BA_TOL, r
    assert r["ba_disps"] < BA_TOL, r
    assert r["motion_only_poses"] < BA_TOL, r


def test_padded_edges_are_inert():
    """Padding edges masked with edge_valid=False changes nothing, in both
    the full and the motion-only step (``tests/test_ba_dense.py``'s
    padding, garbage targets on the padded edges)."""
    s = _ba_scene()
    T = {k: _t(v) for k, v in s.items()}
    E, hw = s["target"].shape[0], s["target"].shape[-1]
    pad = 5
    ii_p = torch.cat([T["ii"], torch.zeros(pad, dtype=T["ii"].dtype)])
    jj_p = torch.cat([T["jj"], torch.ones(pad, dtype=T["jj"].dtype)])
    tgt_p = torch.cat([T["target"], 1e3 * torch.ones(pad, 2, hw)])
    wgt_p = torch.cat([T["weight"], torch.ones(pad, 2, hw)])
    ev = torch.cat([torch.ones(E, dtype=torch.bool),
                    torch.zeros(pad, dtype=torch.bool)])
    p1, d1 = tdense.bundle_adjust(T["target"][None], T["weight"][None],
                                  T["eta"][None], T["poses0"][None],
                                  T["disps0"][None], T["intr"][None],
                                  T["ii"], T["jj"], fixedp=2)
    p2, d2 = tdense.bundle_adjust(tgt_p[None], wgt_p[None], T["eta"][None],
                                  T["poses0"][None], T["disps0"][None],
                                  T["intr"][None], ii_p, jj_p,
                                  edge_valid=ev, fixedp=2)
    m1 = tdense.motion_only(T["target"][None], T["weight"][None],
                            T["poses0"][None], T["disps_gt"][None],
                            T["intr"][None], T["ii"], T["jj"], fixedp=2)
    m2 = tdense.motion_only(tgt_p[None], wgt_p[None], T["poses0"][None],
                            T["disps_gt"][None], T["intr"][None], ii_p, jj_p,
                            edge_valid=ev, fixedp=2)
    assert _gap(p1, p2) < 1e-6 and _gap(d1, d2) < 1e-6 and _gap(m1, m2) < 1e-6


def ba_grad_readings(seed=42):
    """d/d(target, weight) of a scalar of one BA step: a weighted sum of
    the new poses and disparities, in JAX (jax.grad) and in the port."""
    s = _ba_scene(seed)
    rng = np.random.default_rng(seed + 1)
    cp = rng.normal(size=s["poses0"].shape).astype(np.float32)
    cd = rng.normal(size=s["disps0"].shape).astype(np.float32)
    ii, jj = s["ii"], s["jj"]

    def jscalar(target, weight):
        p, d = jdense._ba_single(
            target, weight, jnp.asarray(s["eta"]), jnp.asarray(s["poses0"]),
            jnp.asarray(s["disps0"]), jnp.asarray(s["intr"]),
            jnp.asarray(ii), jnp.asarray(jj),
            edge_valid=jnp.ones(ii.shape, bool), fixedp=2, ep=0.1, lm=1e-4)
        return jnp.sum(p * cp) + jnp.sum(d * cd)

    jg_t, jg_w = jax.jit(jax.grad(jscalar, argnums=(0, 1)))(
        jnp.asarray(s["target"]), jnp.asarray(s["weight"]))
    tt = _t(s["target"]).requires_grad_(True)
    tw = _t(s["weight"]).requires_grad_(True)
    p, d = tdense.ba_step(tt, tw, _t(s["eta"]), _t(s["poses0"]),
                          _t(s["disps0"]), _t(s["intr"]), _t(ii), _t(jj),
                          fixedp=2)
    ((p * _t(cp)).sum() + (d * _t(cd)).sum()).backward()

    def rel(a, b):
        a = np.asarray(a, np.float64)
        return float(np.linalg.norm(a - b.numpy()) / np.linalg.norm(a))

    return {"grad_target": rel(jg_t, tt.grad),
            "grad_weight": rel(jg_w, tw.grad),
            "grad_target_norm": float(np.linalg.norm(np.asarray(jg_t)))}


def test_ba_step_gradient_matches_jax_grad():
    r = ba_grad_readings()
    assert r["grad_target_norm"] > 0
    assert r["grad_target"] < GRAD_REL_TOL, r
    assert r["grad_weight"] < GRAD_REL_TOL, r


# ---------------------------------------------------------------------------
# the solver's gradient, the gradient clip
# ---------------------------------------------------------------------------

def test_solve_psd_grad_finite_on_indefinite():
    """An indefinite system gives a zero step with finite gradients (the
    JAX package's ``test_solve_psd_grad_finite_on_indefinite``); the SPD
    gradient equals JAX's."""
    b = torch.ones(4)
    H_bad = -torch.eye(4)
    H_ok = 2.0 * torch.eye(4)
    assert torch.equal(tsolve(H_bad, b), torch.zeros(4))
    for H in (H_bad, H_ok):
        Hg = H.clone().requires_grad_(True)
        bg = b.clone().requires_grad_(True)
        (tsolve(Hg, bg) ** 2).sum().backward()
        assert torch.isfinite(Hg.grad).all() and torch.isfinite(bg.grad).all()
    Hg = H_ok.clone().requires_grad_(True)
    (tsolve(Hg, b) ** 2).sum().backward()
    jg = jax.grad(lambda M: jnp.sum(jsolve(M, jnp.ones(4)) ** 2))(
        2.0 * jnp.eye(4))
    assert _gap(jg, Hg.grad) < 1e-6
    assert _gap(tsolve(H_ok, b), np.full(4, 0.5)) < 1e-6


def test_gradient_clip_matches_jax():
    """Identity forward; the backward zeroes NaN entries and those above
    0.01 in magnitude, as the JAX package's custom VJP does."""
    g = np.array([0.0, 0.005, -0.0099, 0.0101, -0.02, np.nan, 1.0],
                 np.float32)
    x = torch.linspace(-1, 1, g.size).requires_grad_(True)
    y = tlayers.gradient_clip(x)
    assert torch.equal(y, x)
    y.backward(_t(g))
    _, vjp = jax.vjp(jlayers.gradient_clip, jnp.asarray(x.detach().numpy()))
    assert np.array_equal(x.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
    with torch.no_grad():
        assert tlayers.gradient_clip(x) is x


if __name__ == "__main__":
    torch.set_num_threads(2)
    for name, fn in (("sim3", sim3_readings), ("geometry", geometry_readings),
                     ("dense BA", ba_readings), ("BA gradient",
                                                 ba_grad_readings)):
        for seed in [int(a) for a in sys.argv[1:]] or [None]:
            r = fn() if seed is None else fn(seed)
            print(name, seed, {k: f"{v:.3g}" for k, v in r.items()})
