"""The port's stereo path against the benchmark's plain stereo reference
(``benchmark/reference/stereo.py``, which imports nothing of the port), on
the CPU at a small size: the stereo warp and its Jacobians, the two-view
encoder, one stereo update of the frame path from the tracker's own state,
and the bundle adjustment over stereo edges.

The geometry and the BA run in float64 on both sides, so they agree to
rounding. The encoder runs on seeded random weights in float32 on both
sides, and the port's bfloat16 encode must land outside the same tolerance:
the tolerance tells the two precisions apart. The frame path's update runs
the port as it tracks (bfloat16 networks, float32 geometry) on the trained
weights: with seeded random weights the update operator's flow revisions
are noise, the BA's step runs away (disparities change by ~4e4 at 64x96)
and the rounding of either side decides where it lands.

The new stereo counters of ``TrackPipeline`` are held to the graph's own
(i, i) edges at each update, and are 0 in a monocular run
(tests/test_torch_trace.py).
"""

import os

import numpy as np
import pytest
import torch

from benchmark import checks
from benchmark.loops.track import _Probe
from benchmark.reference import geometry as rgeo
from benchmark.reference import stereo as rstereo
from benchmark.traffic import box_walk_stereo
from droid_slam_tpu_torch.ba import inference as ba_inf
from droid_slam_tpu_torch.geom import projective as pops
from droid_slam_tpu_torch.models import nets, weights
from droid_slam_tpu_torch.slam import fused_frame

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "r5_006000.npz")
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several test processes at
    once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scene(seed, n=5, h=8, w=12):
    """Poses near the identity, disparities in [0.3, 1.2], intrinsics at
    the feature resolution, float64."""
    g = torch.Generator().manual_seed(seed)
    poses = rgeo.exp(0.1 * torch.randn(n, 6, generator=g, dtype=F64))
    disps = 0.3 + 0.9 * torch.rand(n, h, w, generator=g, dtype=F64)
    intr = torch.tensor([11.0, 10.0, w / 2, h / 2], dtype=F64)
    return poses, disps, intr


# the edges: (i, i) stereo edges among monocular ones
II = torch.tensor([0, 1, 1, 2, 3, 2, 4, 3])
JJ = torch.tensor([1, 0, 1, 2, 2, 3, 4, 3])


def test_stereo_warp_and_jacobians():
    """(a) Both edge kinds map the same pixels with the same Jacobians:
    float64 on both sides, so 1e-9 of the largest value is rounding."""
    poses, disps, intr = _scene(0)
    want, wvalid, (Ji, Jj, Jz) = rstereo.warp(poses, disps, intr, II, JJ,
                                              jacobians=True)
    got, valid, (gi, gj, gz) = pops.projective_transform(
        poses, disps, intr.expand(len(poses), 4), II, JJ, jacobian=True)
    assert torch.equal(valid[..., 0] > 0, wvalid)
    for a, b in ((got, want), (gi, Ji), (gj, Jj), (gz[..., 0], Jz)):
        assert (a - b).abs().max() <= 1e-9 * b.abs().max()
    # a stereo edge lands where the baseline puts it: x shifted by
    # -0.1 fx d, y unchanged
    st = II == JJ
    grid = rgeo.coords_grid(8, 12, F64, None)
    shift = want[st] - grid
    assert torch.allclose(shift[..., 0], -0.1 * intr[0] * disps[II[st]])
    assert shift[..., 1].abs().max() < 1e-12


def _rel(x, ref):
    return float((x.double() - ref.double()).norm() / ref.double().norm())


def test_two_view_encoder():
    """(b) ``extract_features`` on a stereo stack (fnet on both views,
    cnet on the left) against ``encode_stereo``, seeded random weights.
    In float32 the two differ by the reassociation of the convolutions'
    sums (~1e-6 of each output); 1e-4 leaves room for it. In bfloat16, the
    port's tracking precision, the gap is ~1e-2: above the tolerance."""
    params = weights.init_params(0)
    g = torch.Generator().manual_seed(1)
    views = torch.randint(0, 256, (2, 64, 96, 3), generator=g,
                          dtype=torch.uint8)
    want = rstereo.encode_stereo(params, views)
    assert [x.shape[0] for x in want] == [2, 1, 1]
    tol = 1e-4
    f32 = nets.extract_features(params, views, torch.float32, cnet_views=1)
    assert max(_rel(a, b) for a, b in zip(f32, want)) <= tol
    bf16 = nets.extract_features(params, views, torch.bfloat16, cnet_views=1)
    assert max(_rel(a, b) for a, b in zip(bf16, want)) > tol
    # each view its own: the right view's features are not the left's
    assert _rel(want[0][1], want[0][0]) > 0.1


def _ba_problem(seed, stereo_only):
    poses, disps, intr = _scene(seed)
    ii, jj = (II[II == JJ], JJ[II == JJ]) if stereo_only else (II, JJ)
    g = torch.Generator().manual_seed(seed + 100)
    E, (h, w) = len(ii), disps.shape[-2:]
    moved = rgeo.retr(poses, 0.01 * torch.randn(len(poses), 6, generator=g,
                                                dtype=F64))
    coords, _, _ = rstereo.warp(moved, disps * 1.05, intr, ii, jj)
    target = coords.reshape(E, -1, 2).transpose(1, 2) \
        + 0.2 * torch.randn(E, 2, h * w, generator=g, dtype=F64)
    weight = 0.1 + 0.9 * torch.rand(E, 2, h * w, generator=g, dtype=F64)
    damping = 1e-4 * torch.rand(len(poses), h, w, generator=g, dtype=F64)
    return poses, disps, intr, damping, target, weight, ii, jj


@pytest.mark.parametrize("stereo_only", [False, True],
                         ids=["stereo_and_mono", "stereo_only"])
def test_stereo_bundle_adjustment(stereo_only):
    """(d) Two Gauss-Newton iterations of the port's BA against the
    reference's, float64 on both sides (rounding: 1e-8 of the step). With
    stereo edges alone the poses stay where they were and the disparities
    of their frames move: the baseline carries no pose weight."""
    poses, disps, intr, damping, target, weight, ii, jj = _ba_problem(
        3, stereo_only)
    t0, t1 = 1, 5
    want_p, want_d = rstereo.bundle_adjust(poses, disps, damping, intr,
                                           target, weight, ii, jj, t0, t1,
                                           lm=1e-4, ep=0.1, iters=2)
    plan = ba_inf.build_plan(ii.numpy(), jj.numpy(), t0, t1, "cpu")
    got_p, got_d = ba_inf.ba_iterations(
        poses, disps, torch.zeros_like(disps), damping, intr, target,
        weight, plan, lm=1e-4, ep=0.1, iters=2)
    for got, want, base in ((got_p, want_p, poses),
                            (got_d, want_d, disps)):
        assert (got - want).abs().max() <= 1e-8 * (want - base).abs().max()
    moved = (want_d - disps).abs().amax(dim=(1, 2))
    if stereo_only:
        assert torch.equal(want_p, poses) and torch.equal(got_p, poses)
        assert bool((moved[ii] > 1e-3).all())
    else:
        assert (want_p - poses)[t0:t1].abs().max() > 1e-3


def _track_with_probe(n_frames=8, seed=1):
    """A stereo ``Droid`` on the frame path, run eagerly on the CPU at
    64x96 (every frame admitted and kept), with the benchmark's probe
    armed at the first update of the frame path and the graph's (i, i)
    edges read at each update's dispatch."""
    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.slam.droid import Droid

    H, W = 64, 96
    images, intr = box_walk_stereo.stream(n_frames, (H, W), 20260101, seed,
                                          0.1, 0.03, 0.1,
                                          torch.device("cpu"))
    cfg = DroidConfig(image_size=(H, W), buffer=n_frames + 4, stereo=True,
                      warmup=4, filter_thresh=-1.0, keyframe_thresh=-1.0,
                      frontend_window=16, frontend_thresh=16.0,
                      frontend_radius=2, frontend_nms=1, fused_frame=True,
                      weights=CKPT)
    droid = Droid(cfg, device="cpu")
    probe = _Probe(droid, lambda: None)
    fp = droid.frame_programs
    seen = []
    run = fp.run

    def graph_count(g, key, ints, *a):
        if ints[fused_frame.HEAD.index("n_iters")] > 0:
            st = g.ii == g.jj
            # a new edge has not aged yet: the frame program runs it first
            seen.append((int(st.sum()), int((st & (g.age == 0)).sum())))
        return run(g, key, ints, *a)
    fp.run = graph_count
    for k in range(n_frames):
        probe.armed = fp.eager >= 1 and not probe.samples
        droid.track(float(k), images[k], intrinsics=intr)
    fp.run = run
    probe.close()
    return droid, probe, seen, images, intr, cfg


def test_frame_path_stereo_update():
    """(c) One update of the frame path (``fused_frame=True``, eagerly on
    the CPU) against ``reference.stereo.frame_update`` from the same
    snapshot, with the stereo edges of the window in it, the readings as
    the benchmark's check computes them. The port's bfloat16 networks set
    the gaps: on texture seeds 1-6 the poses read 0.0023-0.0093, the
    disparities 0.023-0.046, the keyframe distance up to 0.0016 (seed 1:
    0.0041, 0.028, 0.00025). A stereo edge's volume against the left view
    reads 0.72 and 0.90, the baseline left out 0.091 and 0.67, the stereo
    edges given pose weight 0.044 in the poses. The tolerances, 0.02, 0.1
    and 0.005, lie between."""
    if not os.path.exists(CKPT):
        pytest.skip(f"needs the trained checkpoint {CKPT}")
    droid, probe, seen, images, intr, cfg = _track_with_probe()
    assert droid.updates == len(seen) > 0
    assert droid.update_stereo_edges == sum(s for s, _ in seen) > 0
    assert droid.new_stereo_edges == sum(n for _, n in seen) > 0

    s = probe.samples[0]
    assert (s["ii"] == s["jj"]).sum() > 0
    p = {k: v.float() for k, v in droid.params.items()}
    st = checks._state(s, F64, torch.device("cpu"))
    st["keep"] = s["kf_dist"] >= 2.0 * cfg.keyframe_thresh
    with checks.tf32(False):
        P, D, kf = rstereo.frame_update(
            p, st, lambda r: torch.as_tensor(images[int(s["tstamp"][r])]),
            torch.tensor(intr / 8.0, dtype=F64), cfg.beta,
            cfg.motion_damping)
    assert checks._gap(s["post_poses"], P, s["poses"]) <= 0.02
    assert checks._gap(s["post_disps"], D, s["disps"]) <= 0.1
    assert abs(s["kf_dist"] - float(kf)) / float(kf) <= 0.005
