"""The port's tracing (``droid_slam_tpu_torch/utils/trace.py``): the span
helper on and off, the ``droid:`` spans of a tracking run on the frame
path and of a global-BA pass, and the tracker's counters held to the
admission deltas it logs and to what the benchmark's probe reads from the
frame programs' int tables (``benchmark/loops/track.py::_Probe``).

The tracking runs are the tracking slice's scene and settings (64x96,
``tests/test_torch_slice.py``) with a filter threshold at which the
frame path both admits and rejects frames, and drops keyframes."""

import os
from collections import Counter

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from droid_slam_tpu_torch.utils import trace

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "checkpoints", "r5_006000.npz")
H, W = 64, 96
N_FRAMES = 20
CFG = dict(buffer=32, image_size=(H, W), warmup=8, frontend_window=16,
           frontend_thresh=16.0, frontend_radius=2, frontend_nms=1,
           filter_thresh=1.5, keyframe_thresh=0.3)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several test processes at
    once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _events(prof):
    """The trace's ``droid:`` events: (name, start_ns, end_ns, thread,
    kwinputs)."""
    return [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id(),
             e.kwinputs())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(trace.PREFIX)]


def _inside(child, parent):
    return (child[3] == parent[3] and parent[1] <= child[1]
            and child[2] <= parent[2])


def test_span_without_a_profiler_is_the_shared_noop():
    assert not autograd_profiler._is_profiler_enabled
    assert trace.span("track") is trace.NOOP
    assert trace.span("track", {"tstamp": 1.0}) is trace.NOOP
    with trace.span("pack") as s:
        assert s is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
    assert _events(prof) == []


def test_spans_nest_and_follow_the_profilers_flag():
    """``_is_profiler_enabled`` flips with ``start()``/``stop()`` (the
    helper's only check, guarded here against a torch upgrade); spans
    nest as written, carry their args when shapes are recorded, and are
    function-scope events, not user annotations (which get a copy on the
    device's timeline)."""
    prof = profile(activities=[ProfilerActivity.CPU], record_shapes=True)
    prof.start()
    try:
        assert autograd_profiler._is_profiler_enabled
        with trace.span("outer", {"tstamp": 7.0, "why": "new_key"}):
            with trace.span("inner"):
                torch.ones(8).cumsum(0)
            with trace.span("inner"):
                pass
    finally:
        prof.stop()
    assert not autograd_profiler._is_profiler_enabled
    assert trace.span("outer") is trace.NOOP
    ev = _events(prof)
    names = Counter(e[0] for e in ev)
    assert names == {"droid:outer": 1, "droid:inner": 2}
    outer = next(e for e in ev if e[0] == "droid:outer")
    assert outer[4] == {"tstamp": 7.0, "why": "new_key"}
    inner = [e for e in ev if e[0] == "droid:inner"]
    assert all(_inside(e, outer) for e in inner)
    assert inner[0][2] <= inner[1][1]
    assert not any(e.is_user_annotation()
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(trace.PREFIX))


def _frames():
    from droid_slam_tpu_torch.data.synthetic import synthetic_stream
    return [(float(t), img[0], intr) for t, img, intr in synthetic_stream(
        n_frames=N_FRAMES, image_size=(H, W), seed=11, step=0.12,
        rot_step=0.04)]


@pytest.fixture(scope="module", params=[False, True],
                ids=["frame", "spec"])
def tracked(request):
    """A traced run on the CPU: every ``track()`` under the profiler, then
    ``flush()``; the non-speculative run with the benchmark's probe on
    the frame programs."""
    if not os.path.exists(CKPT):
        pytest.skip(f"needs the trained checkpoint {CKPT}")
    from benchmark.loops.track import _Probe
    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.slam.droid import Droid

    spec = request.param
    droid = Droid(DroidConfig(**CFG, weights=CKPT, fused_frame=True,
                              spec_frame=spec), device="cpu")
    probe = None if spec else _Probe(droid, lambda: None)
    frames = _frames()
    prof = profile(activities=[ProfilerActivity.CPU], record_shapes=True)
    prof.start()
    try:
        for t, img, intr in frames:
            droid.track(t, img, intrinsics=intr)
    finally:
        prof.stop()
    droid.flush()
    if probe is not None:
        probe.close()
    return dict(droid=droid, probe=probe, events=_events(prof),
                calls=len(frames), spec=spec)


def test_tracking_spans_nest_under_each_call(tracked):
    droid, ev = tracked["droid"], tracked["events"]
    fp = droid.frame_programs
    tracks = [e for e in ev if e[0] == "droid:track"]
    assert len(tracks) == tracked["calls"]
    assert [e[4]["tstamp"] for e in tracks] == \
        [float(k) for k in range(tracked["calls"])]
    names = Counter(e[0] for e in ev)
    # the frame path: each frame program dispatched once (the strict
    # re-runs of speculation dispatch again)
    assert names["droid:dispatch"] == names["droid:pack"] == \
        fp.eager > 0
    assert names["droid:update_host"] == droid.updates > 0
    assert names["droid:readback_wait"] > 0
    # the strict path: the initialization, its BA iterations inside
    assert names["droid:strict"] > 0 and names["droid:ba"] > 0
    assert names["droid:spec_unwind"] == droid.spec_mis
    if tracked["spec"]:
        assert droid.spec_mis > 0
    for name in ("droid:resolve", "droid:strict", "droid:update_host",
                 "droid:pack", "droid:dispatch", "droid:readback_wait",
                 "droid:proposal", "droid:spec_unwind"):
        for e in ev:
            if e[0] == name:
                assert any(_inside(e, t) for t in tracks), name
    for e in ev:
        if e[0] == "droid:distance":
            assert any(_inside(e, p) for p in ev
                       if p[0] == "droid:proposal")


def test_tracking_counters_match_the_logs_and_the_probe(tracked):
    droid, probe = tracked["droid"], tracked["probe"]
    deltas = np.asarray(droid._delta_log)
    assert droid.admitted == int((deltas > droid.filterx.thresh).sum())
    assert 0 < droid.admitted < len(deltas)   # both outcomes ran
    assert 0 < droid.iters_kept < droid.iters_run
    # a monocular graph has no (i, i) edge
    assert droid.update_stereo_edges == droid.new_stereo_edges == 0
    if probe is None:
        return
    upd = [c for c in probe.calls if c["update"]]
    assert droid.updates == len(upd)
    assert droid.update_edges == sum(c["edges"] for c in upd)
    assert droid.iters_run == sum(c["iters1"] + c["iters2"]
                                  for c in probe.calls)
    assert droid.iters_kept == sum(c["iters1"] + c["iters2"] * c["keep"]
                                   for c in upd)


def test_capture_reasons():
    """``droid:capture``'s ``why``: a new key, a new pool generation, a
    larger probe bucket (every graph dropped)."""
    from droid_slam_tpu_torch.slam import fused_frame
    from droid_slam_tpu_torch.state.video import DepthVideo

    video = DepthVideo((H, W), 8, "cpu")
    fp = fused_frame.FramePrograms(video, fused_frame.Consts(
        beta=0.3, motion_damping=0.5, kf_thresh=1.0, adm_thresh=1.0,
        keep_thresh=2.0))
    key = lambda pb, gen: fused_frame.FrameKey(
        ea=48, ib=8, kb=4, nw=8, pb=pb, ba_shape=(8, 48), fields=(),
        iters1=3, iters2=2, upsample=False, with_volumes=True,
        fused_epilogue=False, generation=gen)
    assert fp._why(key(4, 0)) == "new_key"
    fp.cache = {key(4, 0): None}
    assert fp._why(key(4, 0)._replace(kb=8)) == "new_key"
    assert fp._why(key(4, 1)) == "generation"
    fp._vec_for(8)
    assert fp.cache == {}
    assert fp._why(key(8, 1)) == "probe_bucket"
    assert fp._why(key(8, 1)) == "new_key"


def test_global_ba_pass_spans_each_sweep_chunk():
    """A ``DroidBackend`` pass at t=32: one ``droid:sweep_chunk`` per chunk
    and step, whose edges add up to the pass's, and one ``droid:ba`` per
    step, inside ``droid:gba_pass``."""
    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.models import weights
    from droid_slam_tpu_torch.slam.backend import DroidBackend
    from droid_slam_tpu_torch.state.video import DepthVideo

    t, steps, size = 32, 2, (64, 96)
    h, w = size[0] // 8, size[1] // 8
    g = torch.Generator().manual_seed(5)
    v = DepthVideo(size, t + 8, "cpu")
    ang = torch.linspace(0, 0.6, t)
    with torch.no_grad():
        v.poses[:t, 0] = 0.05 * torch.arange(t, dtype=torch.float32)
        v.poses[:t, 4] = torch.sin(ang / 2)
        v.poses[:t, 6] = torch.cos(ang / 2)
        v.disps[:t] = 0.5 + 0.1 * torch.rand(t, h, w, generator=g)
        v.intrinsics[:] = torch.tensor([w * 0.8, w * 0.8, w / 2, h / 2])
        for name in ("fmaps", "nets", "inps"):
            buf = getattr(v, name)
            buf[:t] = torch.randn(buf[:t].shape, generator=g).to(buf.dtype)
    v.counter = t
    backend = DroidBackend(weights.init_params(0), v, DroidConfig(
        buffer=t + 8, image_size=size, backend_thresh=1e3))
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof, torch.no_grad():
        edges = backend(steps=steps, normalize=False)
    ev = _events(prof)
    names = Counter(e[0] for e in ev)
    chunks = [e for e in ev if e[0] == "droid:sweep_chunk"]
    firsts = sorted({e[4]["first"] for e in chunks})
    assert edges > 0 and len(firsts) > 1
    assert len(chunks) == steps * len(firsts)
    assert sum(e[4]["edges"] for e in chunks) == steps * edges
    assert names["droid:gba_pass"] == names["droid:proposal"] == 1
    assert names["droid:distance"] == 1 and names["droid:ba"] == steps
    gba = next(e for e in ev if e[0] == "droid:gba_pass")
    assert all(_inside(e, gba) for e in ev)


@pytest.mark.cuda
def test_spans_on_the_card_stay_off_the_device_timeline():
    """On the card: a traced frame path captures and replays, its spans
    are host events only (nothing named ``droid:`` on the device's
    timeline, which the benchmark reads as the device's work), and each
    capture says why."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    if not os.path.exists(CKPT):
        pytest.skip(f"needs the trained checkpoint {CKPT}")
    from torch.autograd import DeviceType

    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.slam.droid import Droid

    droid = Droid(DroidConfig(**CFG, weights=CKPT, fused_frame=True),
                  device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for t, img, intr in _frames():
            droid.track(t, img, intrinsics=intr)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    assert not [e.name() for e in events
                if e.name().startswith(trace.PREFIX)
                and e.device_type() == DeviceType.CUDA]
    assert any(e.device_type() == DeviceType.CUDA for e in events)
    ev = _events(prof)
    caps = [e for e in ev if e[0] == "droid:capture"]
    fp = droid.frame_programs
    assert len(caps) == fp.captures > 0 and fp.replays > 0
    assert caps[0][4]["why"] == "new_key"
    assert {e[4]["why"] for e in caps} <= {"new_key", "generation",
                                            "probe_bucket"}
    assert Counter(e[0] for e in ev)["droid:dispatch"] == \
        fp.replays + fp.eager
