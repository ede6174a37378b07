"""The global BA's sweep plan (``state/graph.py::sweep_bounds``,
``FactorGraph._sweep_plan``): chunks of whole source frames under a cap on
edges x pixels, planned and uploaded once per ``update_lowmem`` call.

One ``update_lowmem`` step on the t=32, 64x96 video of
``tests/test_torch_trace.py::test_global_ba_pass_spans_each_sweep_chunk``
(seeded random weights, the backend's proposal) under three caps: many
small chunks (frames whose edges alone pass the cap among them), one chunk,
and an uneven split. Each is held bit for bit to the sweep the port ran
before the plan (``_eight_frame_step``: chunks of 8 source frames, each
chunk's tables built and uploaded in the chunk), alone, with the inactive
edges in the BA and with ``upsample``. Chunks are independent within a
step and each frame's edges keep their order, so on the CPU the chunking
changes no bit.

Also: the plan's invariants, and that the step loop copies nothing to the
device (as many uploads for 3 steps as for 1) and runs the plan's chunks
on every step (``sweep_chunks`` / ``sweep_steps``)."""

import numpy as np
import pytest
import torch

from droid_slam_tpu_torch.ba import inference as ba_inference
from droid_slam_tpu_torch.models import nets
from droid_slam_tpu_torch.ops import alt_corr_cuda
from droid_slam_tpu_torch.ops import corr as corr_ops
from droid_slam_tpu_torch.state import edge_update
from droid_slam_tpu_torch.state import graph as graph_mod
from droid_slam_tpu_torch.state.graph import FactorGraph

T, SIZE = 32, (64, 96)
HW = (SIZE[0] // 8) * (SIZE[1] // 8)
# caps in edges x pixels: chunks of ~12 edges (most frames alone, some
# past the cap), everything in one chunk, and chunks of ~7 frames
CAPS = {"small": 12 * HW, "one": 1 << 40, "uneven": 100 * HW}
MODES = ("plain", "inactive", "upsample")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    from droid_slam_tpu_torch.models import weights
    return weights.init_params(0)


def _graph(params, mode, device="cpu"):
    """The trace test's video (t=32 at 64x96), and a graph over it with the
    backend's proposal (max_factors 16t, radius 2, nms 3, beta 0.3); with
    ``inactive`` the edges from frames below 6 moved to the inactive
    store."""
    from droid_slam_tpu_torch.state.video import DepthVideo
    t, (H, W) = T, SIZE
    h, w = H // 8, W // 8
    g = torch.Generator().manual_seed(5)
    v = DepthVideo(SIZE, t + 8, device, upsample=(mode == "upsample"))
    ang = torch.linspace(0, 0.6, t)
    with torch.no_grad():
        v.poses[:t, 0] = 0.05 * torch.arange(t, dtype=torch.float32)
        v.poses[:t, 4] = torch.sin(ang / 2)
        v.poses[:t, 6] = torch.cos(ang / 2)
        v.disps[:t] = 0.5 + 0.1 * torch.rand(t, h, w, generator=g).to(
            device)
        v.intrinsics[:] = torch.tensor([w * 0.8, w * 0.8, w / 2, h / 2])
        for name in ("fmaps", "nets", "inps"):
            buf = getattr(v, name)
            buf[:t] = torch.randn(buf[:t].shape, generator=g).to(buf)
    v.counter = t
    fg = FactorGraph(v, params, max_factors=16 * t, corr_impl="alt",
                     upsample=(mode == "upsample"))
    fg.add_proximity_factors(rad=2, nms=3, thresh=1e3, beta=0.3)
    if mode == "inactive":
        fg.rm_factors(fg.ii < 6, store=True)
    return fg


def _eight_frame_step(g, use_inactive):
    """One ``update_lowmem`` step as the port ran it before the sweep plan:
    chunks of 8 source frames in edge order, each chunk's tables built on
    the host and uploaded inside the chunk, the weights merged per call."""
    v = g.video
    t, c = v.counter, v.fmaps.shape[1]
    ii, jj = g.ii, g.jj
    fpyr = corr_ops.build_fmap_pyramid(v.fmaps[:t].reshape(
        t * c, *v.fmaps.shape[2:]))
    rows = (g._dev(ii * c), g._dev(jj * c + (ii == jj)))
    chunks = [(s, np.flatnonzero((ii >= s) & (ii < s + 8)))
              for s in range(int(ii.min()), int(jj.max()) + 1, 8)]
    n_inac = len(g.ii_inac) if use_inactive else 0
    plan = ba_inference.build_plan(
        np.concatenate([g.ii_inac[:n_inac], ii]),
        np.concatenate([g.jj_inac[:n_inac], jj]), 1, t, v.device)
    for s, idx in chunks:
        if not len(idx):
            continue
        sel = g._dev(idx)
        ii_t, jj_t = g._dev(ii[idx]), g._dev(jj[idx])
        coords1, motn = edge_update.motion_features(
            v.poses, v.disps, v.intrinsics, ii_t, jj_t, g.target[sel])
        corr = alt_corr_cuda.alt_lookup(
            fpyr, coords1.reshape(len(idx), -1, 2), rows[0][sel],
            rows[1][sel])
        net, delta, weight, eta, upmask = nets.update_module(
            g.params, g.net[sel], v.inps[ii_t],
            edge_update.corr_nchw(corr, g.h, g.w), motn, ii=ii_t - s,
            num_frames=8, compute_upmask=g.upsample)
        g.net[sel] = net
        g.target[sel], g.weight[sel] = edge_update.target_weight(
            coords1, delta, weight)
        frames = np.unique(ii[idx])
        v.damping[g._dev(frames)] = eta[g._dev(frames - s)].float()
        if g.upsample:
            f = g._dev(frames)
            v.disps_up[f] = nets.upsample_disp(v.disps[f],
                                               upmask[g._dev(frames - s)])
    v.ba(torch.cat([g.target_inac[:n_inac], g.target]),
         torch.cat([g.weight_inac[:n_inac], g.weight]), plan, iters=2,
         lm=1e-5, ep=1e-2)


def _state(g):
    v = g.video
    out = {"poses": v.poses[:T], "disps": v.disps[:T],
           "damping": v.damping[:T], "net": g.net, "target": g.target,
           "weight": g.weight}
    if g.upsample:
        out["disps_up"] = v.disps_up[:T]
    return {k: x.clone() for k, x in out.items()}


@pytest.fixture(scope="module")
def eight_frame(params):
    """Each mode's step under the 8-frame sweep."""
    out = {}
    for mode in MODES:
        g = _graph(params, mode)
        with torch.no_grad():
            _eight_frame_step(g, mode == "inactive")
        out[mode] = (len(g.ii), _state(g))
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cap", sorted(CAPS))
def test_every_cap_gives_the_eight_frame_step_bit_for_bit(
        params, eight_frame, monkeypatch, cap, mode):
    monkeypatch.setattr(graph_mod, "SWEEP_EDGE_PIXELS", CAPS[cap])
    g = _graph(params, mode)
    n_chunks = len(g._sweep_plan(1))
    before = g.video.poses[:T].clone()
    with torch.no_grad():
        g.update_lowmem(steps=1, use_inactive=(mode == "inactive"))
    n_edges, want = eight_frame[mode]
    assert len(g.ii) == n_edges > 100
    assert (n_chunks == 1) == (cap == "one")
    assert n_chunks > {"small": 20, "one": 0, "uneven": 2}[cap]
    if mode == "inactive":
        assert len(g.ii_inac) > 0
    got = _state(g)
    assert set(got) == set(want)
    assert (got["poses"] - before).abs().max() > 1e-4
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _check_bounds(ii, hw, cap):
    order, bounds = graph_mod.sweep_bounds(ii, hw, cap)
    ii_s = ii[order]
    # every edge in exactly one chunk, frames in order, each frame's edges
    # in edge order
    assert sorted(order.tolist()) == list(range(len(ii)))
    assert np.all(np.diff(ii_s) >= 0)
    for f in np.unique(ii):
        assert np.all(np.diff(order[ii_s == f]) > 0)
    assert [lo for lo, _ in bounds] == [0] + [hi for _, hi in bounds[:-1]]
    assert bounds[-1][1] == len(ii)
    for lo, hi in bounds:
        assert hi > lo
        # whole source frames
        assert lo == 0 or ii_s[lo - 1] != ii_s[lo]
        # under the cap unless one frame alone, and no room for the next
        if (hi - lo) * hw > cap:
            assert ii_s[lo] == ii_s[hi - 1]
        if hi < len(ii):
            nxt = np.count_nonzero(ii_s == ii_s[hi])
            assert (hi - lo + nxt) * hw > cap
    return bounds


@pytest.mark.parametrize("seed", range(4))
def test_the_plan_holds_whole_frames_in_order_under_the_cap(seed):
    rng = np.random.default_rng(seed)
    # a few frames with many edges among many with few, shuffled
    ii = np.concatenate([rng.integers(0, 40, int(rng.integers(1, 300)))]
                        + [np.full(int(rng.integers(20, 80)), f)
                           for f in rng.integers(0, 40, 3)])
    ii = rng.permutation(ii)
    hw = int(rng.integers(1, 50))
    for cap in (hw, 7 * hw, int(rng.integers(1, 5000)), 1 << 40):
        bounds = _check_bounds(ii, hw, cap)
        if cap >= len(ii) * hw:
            assert len(bounds) == 1


def test_the_planned_tables_are_the_edges_own(params, monkeypatch):
    """Each chunk's device tables read what the host's edge lists say."""
    monkeypatch.setattr(graph_mod, "SWEEP_EDGE_PIXELS", CAPS["uneven"])
    g = _graph(params, "plain")
    c = g.video.fmaps.shape[1]
    chunks = g._sweep_plan(c)
    assert len(_check_bounds(g.ii, HW, CAPS["uneven"])) == len(chunks) > 2
    sel = torch.cat([ch.sel for ch in chunks]).numpy()
    assert sorted(sel.tolist()) == list(range(len(g.ii)))
    for ch in chunks:
        s = ch.sel.numpy()
        ii, jj = g.ii[s], g.jj[s]
        frames = np.unique(ii)
        assert ch.g0 == ii.min() and ch.span == ii.max() - ii.min() + 1
        np.testing.assert_array_equal(ch.ii.numpy(), ii)
        np.testing.assert_array_equal(ch.jj.numpy(), jj)
        np.testing.assert_array_equal(ch.agg.numpy(), ii - ch.g0)
        np.testing.assert_array_equal(ch.src.numpy(), ii * c)
        np.testing.assert_array_equal(ch.dst.numpy(), jj * c + (ii == jj))
        np.testing.assert_array_equal(ch.frames.numpy(), frames)
        np.testing.assert_array_equal(ch.offsets.numpy(), frames - ch.g0)
        assert ch.src.is_contiguous() and ch.dst.is_contiguous()


def test_the_step_loop_copies_nothing_to_the_device(params, monkeypatch):
    monkeypatch.setattr(graph_mod, "SWEEP_EDGE_PIXELS", CAPS["uneven"])
    calls = {}

    def counted(owner, name):
        orig = getattr(owner, name)

        def f(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return orig(*a, **k)
        monkeypatch.setattr(owner, name, f)

    counted(FactorGraph, "_dev")
    counted(torch, "as_tensor")
    counted(torch, "tensor")
    counted(torch, "from_numpy")
    counts = {}
    for steps in (1, 3):
        g = _graph(params, "plain")
        n_chunks = len(g._sweep_plan(1))
        calls.clear()
        with torch.no_grad():
            g.update_lowmem(steps=steps)
        counts[steps] = dict(calls)
        assert g.sweep_steps == steps
        assert g.sweep_chunks == steps * n_chunks
    assert counts[1] == counts[3]
    # the sweep's tables in one upload (the BA's plan uploads its own)
    assert counts[1]["_dev"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "upsample"])
def test_on_the_card_the_sweep_never_waits_for_the_device(params, mode,
                                                          monkeypatch):
    """On the card, every sweep chunk runs under
    ``torch.cuda.set_sync_debug_mode("error")``: an upload from the host or
    a read of a device value inside a chunk raises. Two steps of the
    uneven split; the state stays finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sync check is CUDA's")
    monkeypatch.setattr(graph_mod, "SWEEP_EDGE_PIXELS", CAPS["uneven"])
    chunk = FactorGraph._lowmem_chunk

    def strict(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return chunk(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    monkeypatch.setattr(FactorGraph, "_lowmem_chunk", strict)
    dev = torch.device("cuda")
    g = _graph({k: x.to(dev) for k, x in params.items()}, mode, dev)
    with torch.no_grad():
        g.update_lowmem(steps=2)
    torch.cuda.synchronize()
    assert g.sweep_steps == 2 and g.sweep_chunks == 2 * len(
        g._sweep_plan(1)) > 4
    assert torch.isfinite(g.video.poses[:T]).all()
    assert torch.isfinite(g.video.disps[:T]).all()
    if mode == "upsample":
        assert torch.isfinite(g.video.disps_up[:T]).all()
