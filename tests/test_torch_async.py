"""The port's asynchronous SLAM path against the JAX package and against the
port's synchronous path.

Units, from the same inputs in both frameworks:
- ``align_pose_fragments`` on seeded poses: the scale and dG to 1e-5;
- ``update_lowmem(use_inactive=True)``: one global-BA step from a
  JAX-tracked state (the 14 frames of tests/test_torch_terminate.py) and
  a graph with inactive edges, both carried into the port;
- ``DroidAsyncBackend.__call__`` twice, the second time after 4 more
  keyframes: edges, ages and inactive edges equal;
- ``DroidAsync._sync_and_run_backend`` driven by hand at fixed counters,
  monocular (scale aligned) and with sensor depth (scale 1): t0/t1, the
  scale and dG to 1e-5, the poses after the backend within bounds.
Poses after a BA step are held to the bounds of tests/test_torch_terminate.py
(both frameworks run the update operator in bf16 and round at different
places: a tenth of the step plus 1e-4, the median relative disparity gap
to 0.02).

End to end, on the CPU: ``DroidAsync`` (backend thread) and
``DroidAsyncProcess`` (backend process), through ``make_droid``, track 40
frames at 64x96 with the bench's thresholds (every frame a keyframe),
``sleep_time=0.5`` and ``backend_iters=1``, then ``terminate(stream)``;
each finishes within its join timeout after at least one backend cycle, and
its trajectory lands within E2E_ATE_REL of the synchronous port's on the
same frames. The scene is the bench's noise texture seen through a window
that slides 4 px a frame: the bench's own roll wraps the texture around, a
motion no camera makes, and its trajectories wander so far that the two
paths' ATE could not tell a right backend from a wrong one. The backend's
cycles fall where the wall clock puts them. Run this file as a script to
print the readings behind E2E_ATE_REL:
    PYTHONPATH=. python tests/test_torch_async.py 0 1 2 3 4 5

On the card (marked ``cuda``), each facade's one backend cycle is held to
the same cycle driven by hand from the tracker's final keyframes.
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

H, W = 64, 96
CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "r5_006000.npz")
CFG = dict(buffer=32, image_size=(H, W), warmup=8, frontend_window=16,
           frontend_thresh=16.0, frontend_radius=2, frontend_nms=1,
           filter_thresh=-1.0, keyframe_thresh=-1.0)
# the end-to-end runs: the bench's scene at 64x96
E2E = dict(frames=40, buffer=64, sleep_time=0.5, backend_iters=1,
           join_timeout=300.0)
# ATE of an asynchronous facade's trajectory against the synchronous port's,
# as a share of the synchronous trajectory's RMS spread (E2E's schedule).
# Readings on texture seeds 0-5 (run this file as a script), thread /
# process: 0.068/0.071, 0.080/0.092, 0.170/0.162, 0.132/0.125,
# 0.160/0.141, 0.114/0.135. The bound is 2x the largest; a trajectory
# collapsed to one point reads 1.0 (the scaled alignment shrinks it to the
# centroid).
E2E_ATE_REL = 0.34
# the CUDA test's schedule: the backend sleeps through tracking, so its one
# cycle is the last, over all 40 keyframes, with one step
LAST_CYCLE = dict(E2E, sleep_time=3600.0)
# bound on the largest gap between that cycle's poses and the same cycle
# driven by hand from the tracker's final keyframes. Card readings (NVIDIA
# H100 80GB HBM3, 700 W, two calls), thread / process: 3.3e-5 / 3.7e-5 and
# 2.5e-5 / 1.3e-4 (the BA's sums use atomics, whose order varies), and
# 1.2 / 2.3 and 1.3 / 2.2 for the same cycle with no BA step (the
# control). The bound is 7.7x the largest reading and 1/1200 of the
# smallest control.
REPLAY_POSE_TOL = 1e-3


def _skip_without_checkpoint():
    if not os.path.exists(CKPT):
        pytest.skip(f"needs the trained checkpoint {CKPT}: with random "
                    "weights the two pipelines part at the first edge "
                    "proposal")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# fragment alignment
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_align_pose_fragments_matches_jax(seed):
    """A fragment and its image under a known similarity plus noise: the
    port's scale and dG equal JAX's to 1e-5 (f32 both)."""
    import jax.numpy as jnp
    from droid_slam_tpu.lie import se3 as jse3
    from droid_slam_tpu.slam.align import align_pose_fragments as jalign
    from droid_slam_tpu_torch.lie import se3 as tse3
    from droid_slam_tpu_torch.slam.align import align_pose_fragments

    rng = np.random.default_rng(seed)
    xi = (rng.normal(size=(9, 6)) * [0.5, 0.5, 0.5, 0.2, 0.2, 0.2]) \
        .astype(np.float32)
    p0 = tse3.exp(torch.as_tensor(xi))
    g = tse3.exp(torch.as_tensor(rng.normal(size=(1, 6)).astype(np.float32)
                                 * 0.3))
    s_true = float(rng.uniform(0.5, 2.0))
    p1 = tse3.mul(g, torch.cat([p0[:, :3] * s_true, p0[:, 3:]], -1))
    p1 = tse3.mul(tse3.exp(torch.as_tensor(
        0.01 * rng.normal(size=(9, 6)).astype(np.float32))), p1)

    dG, s = align_pose_fragments(p0, p1)
    jdG, js = jalign(jnp.asarray(p0.numpy()), jnp.asarray(p1.numpy()))
    assert abs(float(s) - float(js)) <= 1e-5 * max(1.0, abs(float(js)))
    np.testing.assert_allclose(dG.numpy(), np.asarray(jdG), atol=1e-5)
    assert abs(float(s) - s_true) < 0.1 * s_true   # it finds the scale
    del jse3


# ---------------------------------------------------------------------------
# the video's lock
# ---------------------------------------------------------------------------

def test_video_snapshot_never_sees_a_torn_frame():
    """Writer threads rewrite frames (every field of frame i set to one
    value) and remove keyframes while readers take ``read_frames`` with
    the count under the lock: each frame read holds one value in every
    field, and the count covers what was read."""
    import threading

    from droid_slam_tpu_torch.state.video import DepthVideo

    v = DepthVideo((16, 16), 8, "cpu")
    for i in range(8):
        v.set_frame(i, float(i), pose=torch.full((7,), float(i)),
                    disp=float(i))
    stop, bad, interval = threading.Event(), [], sys.getswitchinterval()

    def writer(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            i, x = int(rng.integers(0, 7)), float(rng.integers(0, 1000))
            if rng.uniform() < 0.2:
                with v.get_lock():
                    v.rm_keyframe(i)
                    v.set_frame(v.counter - 1, x, pose=torch.full((7,), x),
                                disp=x)
            else:
                v.set_frame(i, x, pose=torch.full((7,), x), disp=x)

    def reader():
        for _ in range(300):
            with v.get_lock():
                n = v.counter
                f = v.read_frames(0, n)
            for k in range(n):
                vals = {float(f["tstamp"][k]), *f["poses"][k].tolist(),
                        *f["disps"][k].flatten().tolist()}
                if len(vals) != 1:
                    bad.append((k, vals))

    sys.setswitchinterval(1e-6)
    try:
        ws = [threading.Thread(target=writer, args=(s,)) for s in range(4)]
        rs = [threading.Thread(target=reader) for _ in range(4)]
        for t in ws + rs:
            t.start()
        for t in rs:
            t.join(timeout=120)
        stop.set()
        for t in ws:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ws + rs)
    assert not bad, bad[:3]


# ---------------------------------------------------------------------------
# a JAX-tracked state
# ---------------------------------------------------------------------------

_BF16_FIELDS = ("fmaps", "nets", "inps")


def _frames(seed=11, n=14):
    from droid_slam_tpu.data.synthetic import synthetic_stream
    return list(synthetic_stream(n_frames=n, image_size=(H, W), seed=seed,
                                 step=0.12, rot_step=0.04))


@pytest.fixture(scope="module")
def tracked():
    """JAX's video state after tracking 14 synthetic frames and a flush,
    as f32 numpy, and JAX's parameters."""
    _skip_without_checkpoint()
    from droid_slam_tpu.config import DroidConfig
    from droid_slam_tpu.slam import Droid

    droid = Droid(DroidConfig(**CFG, weights=CKPT))
    for t, img, intr in _frames():
        droid.track(float(t), img[0], intrinsics=intr)
    droid.flush()
    snap = {k: np.asarray(v, np.float32)
            for k, v in droid.video.buf._asdict().items()}
    snap["counter"] = droid.video.counter
    return dict(snap=snap, params=droid.params)


def _jax_fill(v, snap, upto=None):
    """JAX video v takes the snapshot's buffers (frames [0, upto))."""
    import jax.numpy as jnp
    from droid_slam_tpu.state.video import VideoBuffers
    n = snap["counter"] if upto is None else upto
    bufs = {}
    for k in VideoBuffers._fields:
        a = snap[k].copy()
        cur = np.asarray(getattr(v.buf, k), np.float32)
        a[n:] = cur[n:]
        bufs[k] = jnp.asarray(a, jnp.bfloat16 if k in _BF16_FIELDS
                              else jnp.float32)
    v.buf = VideoBuffers(**bufs)
    v.counter = n


def _torch_fill(v, snap, upto=None):
    """Port video v takes the snapshot's buffers (frames [0, upto))."""
    n = snap["counter"] if upto is None else upto
    B = v.buffer
    for name in ("tstamp", "poses", "disps", "disps_sens", "intrinsics",
                 "damping"):
        getattr(v, name)[:n].copy_(torch.as_tensor(snap[name][:n]))
    for name in ("nets", "inps"):
        getattr(v, name)[:n].copy_(torch.as_tensor(snap[name][:n])
                                   .permute(0, 3, 1, 2))
    v.fmaps[:n].copy_(torch.as_tensor(snap["fmaps"][:n])
                      .permute(0, 1, 4, 2, 3))
    v.counter = n
    assert B >= n


def _videos(snap, buffer=32):
    from droid_slam_tpu.state.video import DepthVideo as JVideo
    from droid_slam_tpu_torch.state.video import DepthVideo as TVideo
    jv, tv = JVideo((H, W), buffer), TVideo((H, W), buffer, "cpu")
    _jax_fill(jv, snap)
    _torch_fill(tv, snap)
    return jv, tv


def _pose_gaps(jp, tp, before):
    """(the step JAX took, the port's gap to JAX) on poses [n,7]."""
    return np.abs(jp - before).max(), np.abs(tp - jp).max()


def _disp_gap(jd, td):
    return float(np.median(np.abs(td - jd) / jd))


# ---------------------------------------------------------------------------
# the global BA with inactive edges
# ---------------------------------------------------------------------------

def _carry_graph(jg, tg):
    """The port's graph tg takes JAX graph jg's edges and per-edge state."""
    slots = jg._slots()
    tg.ii, tg.jj, tg.age = jg.ii.copy(), jg.jj.copy(), jg.age.copy()
    tg.net = torch.as_tensor(np.asarray(jg.net[slots], np.float32)) \
        .permute(0, 3, 1, 2).to(torch.bfloat16).contiguous()
    tg.target = torch.as_tensor(np.asarray(jg.target[slots]))
    tg.weight = torch.as_tensor(np.asarray(jg.weight[slots]))
    tg.ii_inac, tg.jj_inac = jg.ii_inac.copy(), jg.jj_inac.copy()
    tg.target_inac = torch.as_tensor(
        np.asarray(jg.target_inac[jg.inac_slots]))
    tg.weight_inac = torch.as_tensor(
        np.asarray(jg.weight_inac[jg.inac_slots]))


def test_update_lowmem_with_inactive_edges_matches_jax(tracked):
    """One update_lowmem step with use_inactive=True from the same video
    and graph state (active edges plus inactive ones with the weights of an
    earlier step): the same edges, poses and disparities within the
    bounds; the inactive edges move the port's result by more than its gap
    to JAX."""
    from droid_slam_tpu.config import DroidConfig as JConfig
    from droid_slam_tpu.state.graph import FactorGraph as JGraph
    from droid_slam_tpu_torch.models import weights as tweights
    from droid_slam_tpu_torch.state.graph import FactorGraph as TGraph

    cfg = JConfig(**CFG)
    jv, _ = _videos(tracked["snap"])
    jg = JGraph(jv, tracked["params"], corr_impl="alt", max_factors=-1)
    jg.add_proximity_factors(rad=cfg.backend_radius, nms=cfg.backend_nms,
                             thresh=cfg.backend_thresh, beta=cfg.beta)
    jg.update_lowmem(steps=1)
    jg.rm_factors(jg.ii < 5, store=True)
    assert len(jg.ii_inac) > 0 and len(jg.ii) > 0

    snap = dict(tracked["snap"])
    snap["poses"] = np.asarray(jv.buf.poses, np.float32)
    snap["disps"] = np.asarray(jv.buf.disps, np.float32)
    snap["damping"] = np.asarray(jv.buf.damping, np.float32)
    n = snap["counter"]
    params = tweights.load(CKPT, "cpu")
    results = {}
    for use_inactive in (True, False):
        _, tv = _videos(snap)
        tg = TGraph(tv, params, corr_impl="alt")
        _carry_graph(jg, tg)
        tg.update_lowmem(steps=1, use_inactive=use_inactive)
        results[use_inactive] = (tv.poses[:n].numpy(), tv.disps[:n].numpy(),
                                 tg.ii.copy(), tg.jj.copy())
    edges = (jg.ii.copy(), jg.jj.copy())
    jg.update_lowmem(steps=1, use_inactive=True)
    jp, jd = np.asarray(jv.buf.poses[:n]), np.asarray(jv.buf.disps[:n])
    tp, td, tii, tjj = results[True]
    np.testing.assert_array_equal(tii, edges[0])
    np.testing.assert_array_equal(tjj, edges[1])
    moved, gap = _pose_gaps(jp, tp, snap["poses"][:n])
    dgap = _disp_gap(jd, td)
    by_inactive = np.abs(results[False][0] - tp).max()
    print("update_lowmem(use_inactive)", dict(
        pose_moved=moved, pose_gap=gap, disp_median_gap=dgap,
        inactive_moves_port_by=by_inactive))
    assert moved > 1e-3
    assert gap <= 0.1 * moved + 1e-4
    assert dgap <= 0.02
    assert by_inactive > gap


# ---------------------------------------------------------------------------
# the persistent-graph backend
# ---------------------------------------------------------------------------

def test_async_backend_twice_matches_jax(tracked):
    """DroidAsyncBackend on keyframes [0, 10) with 8 steps (every edge ages
    past max_age 7 and turns inactive), then on [0, 14) with one step: after
    each call the same active edges, ages and inactive edges as JAX, and
    poses within the bounds (measured from the state before each call)."""
    from droid_slam_tpu.config import DroidConfig as JConfig
    from droid_slam_tpu.slam.backend import DroidAsyncBackend as JBackend
    from droid_slam_tpu_torch.config import DroidConfig as TConfig
    from droid_slam_tpu_torch.models import weights as tweights
    from droid_slam_tpu_torch.slam.backend import DroidAsyncBackend

    snap = tracked["snap"]
    jv, tv = _videos(snap)
    _jax_fill(jv, snap, upto=10)
    _torch_fill(tv, snap, upto=10)
    jb = JBackend(tracked["params"], jv, JConfig(**CFG))
    tb = DroidAsyncBackend(tweights.load(CKPT, "cpu"), tv, TConfig(**CFG))
    for steps, upto in ((8, 10), (1, 14)):
        if upto > jv.counter:
            # new keyframes arrive; the earlier ones keep each backend's
            # own optimized state, so the step is measured from JAX's
            _jax_fill(jv, snap, upto=upto)
            _torch_fill(tv, snap, upto=upto)
            for name in ("poses", "disps"):
                getattr(tv, name)[:10] = torch.as_tensor(
                    np.asarray(getattr(jv.buf, name)[:10]))
        before = np.asarray(jv.buf.poses[:upto])
        jb(steps, normalize=False)
        edges = tb(steps, normalize=False)
        jg, tg = jb.graph, tb.graph
        assert edges > 0
        np.testing.assert_array_equal(tg.ii, jg.ii)
        np.testing.assert_array_equal(tg.jj, jg.jj)
        np.testing.assert_array_equal(tg.age, jg.age)
        np.testing.assert_array_equal(tg.ii_inac, jg.ii_inac)
        np.testing.assert_array_equal(tg.jj_inac, jg.jj_inac)
        jp, jd = np.asarray(jv.buf.poses[:upto]), \
            np.asarray(jv.buf.disps[:upto])
        tp, td = tv.poses[:upto].numpy(), tv.disps[:upto].numpy()
        moved, gap = _pose_gaps(jp, tp, before)
        dgap = _disp_gap(jd, td)
        print("async backend", steps, dict(
            edges=edges, inactive=len(tg.ii_inac), pose_moved=moved,
            pose_gap=gap, disp_median_gap=dgap))
        assert moved > 1e-3
        assert gap <= 0.1 * moved + 1e-4
        assert dgap <= 0.02
    assert len(tg.ii_inac) > 0       # the first call's edges retired


# ---------------------------------------------------------------------------
# one backend cycle, driven by hand
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sensor", [False, True], ids=["mono", "rgbd"])
def test_sync_and_run_backend_matches_jax(tracked, sensor):
    """Two cycles of ``_sync_and_run_backend`` at fixed counters (14
    keyframes: [0, 9), then the last one, [7, 14)), no thread: the same
    t0/t1; before the second, the port's backend video takes JAX's, so the
    alignment (monocular: a scale; with sensor depth: 1) sees the same
    inputs, and its scale and dG agree to 1e-5; the poses after each cycle
    within the bounds."""
    from droid_slam_tpu.config import DroidConfig as JConfig
    from droid_slam_tpu.slam.async_droid import DroidAsync as JAsync
    from droid_slam_tpu_torch.config import DroidConfig as TConfig
    from droid_slam_tpu_torch.slam.async_droid import DroidAsync

    snap = dict(tracked["snap"])
    if sensor:   # the tracked disparities as the sensor's
        snap["disps_sens"] = snap["disps"].copy()
    kw = dict(sleep_time=3600.0, backend_iters=2)
    jd = JAsync(JConfig(**CFG, weights=CKPT), **kw)
    td = DroidAsync(TConfig(**CFG, weights=CKPT), device="cpu", **kw)
    _jax_fill(jd.video, snap)
    _torch_fill(td.video, snap)
    n = snap["counter"]
    seen = []
    orig = JAsync._sync_and_run_backend.__globals__["align_pose_fragments"]

    def spy(p0, p1):
        dG, s = orig(p0, p1)
        seen.append((np.asarray(dG), float(s)))
        return dG, s

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(JAsync._sync_and_run_backend.__globals__,
                   "align_pose_fragments", spy)
        for is_last in (False, True):
            if is_last:   # the same backend state on both sides
                for name in ("poses", "disps"):
                    getattr(td.video2, name)[:] = torch.as_tensor(
                        np.asarray(getattr(jd.video2.buf, name)))
            before = np.asarray(jd.video2.buf.poses)
            t0 = max(jd.video2.counter - 2, 0)
            jd._sync_and_run_backend(is_last)
            cycle = td._sync_and_run_backend(is_last)
            t1 = jd.video2.counter
            assert (cycle["t0"], cycle["t1"]) == (t0, t1)
            assert (t0, t1) == ((0, n - 5) if not is_last else (n - 7, n))
            if is_last:
                jdG, js = seen[-1]
                want_s = 1.0 if sensor else js
                assert abs(cycle["scale"] - want_s) <= 1e-5 * max(1, want_s)
                np.testing.assert_allclose(cycle["dG"], jdG, atol=1e-5)
                if not sensor:
                    assert abs(js - 1.0) > 1e-4   # a scale was aligned
            jp = np.asarray(jd.video2.buf.poses[:t1])
            tp = td.video2.poses[:t1].numpy()
            moved, gap = _pose_gaps(jp, tp, before[:t1])
            dgap = _disp_gap(np.asarray(jd.video2.buf.disps[:t1]),
                             td.video2.disps[:t1].numpy())
            print("cycle", is_last, sensor, dict(
                t0=t0, t1=t1, edges=cycle["edges"], scale=cycle["scale"],
                pose_moved=moved, pose_gap=gap, disp_median_gap=dgap))
            assert gap <= 0.1 * moved + 1e-4
            assert dgap <= 0.02
    jd._stop.set()       # JAX's idle thread ends
    assert td.terminate().shape == (n, 7)   # the port's last cycle
    assert td.cycles[-1]["t1"] == n and not td._thread.is_alive()


# ---------------------------------------------------------------------------
# end to end on the CPU
# ---------------------------------------------------------------------------

def _slide_frame(base, t, w):
    """Frame t of the sliding scene: the bench's noise texture, made 4n px
    wider, seen through a w-px window that moves 4 px a frame (the bench
    rolls the image around instead, a motion no camera makes)."""
    return np.ascontiguousarray(base[:, 4 * t:4 * t + w])


def _slide_stream(base, intr, n, w):
    for k in range(0, n, 2):
        yield k + 0.5, _slide_frame(base, k if k % 4 else k + 1, w), intr


def rel_ate(traj, ref):
    """ATE (scaled Umeyama alignment of camera positions) over ref's RMS
    spread about its centroid."""
    from droid_slam_tpu_torch.eval.ate import ate_rmse
    spread = np.sqrt(((ref[:, :3] - ref[:, :3].mean(0)) ** 2).sum(1).mean())
    return ate_rmse(traj[:, :3], ref[:, :3])[0] / spread


def run_bench(kind, seed=0, frames=40, buffer=64, sleep_time=0.5,
              backend_iters=1, join_timeout=300.0, size=(H, W),
              device="cpu", **flags):
    """make_droid on the sliding scene (texture from ``seed``) with the
    bench's thresholds (every frame a keyframe), fused epilogues; kind
    "sync", "thread" or "process"; ``flags``: more DroidConfig fields (the
    tracking path's).
    Returns (trajectory [frames/2, 7], backend cycles before terminate(),
    seconds)."""
    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.slam import make_droid

    h, w = size
    cfg = DroidConfig(buffer=buffer, image_size=(h, w), warmup=8,
                      filter_thresh=-1.0, keyframe_thresh=-1.0,
                      frontend_window=20, frontend_thresh=17.5,
                      frontend_radius=2, frontend_nms=1, weights=CKPT,
                      gru_fused_epilogue=True, asynchronous=kind != "sync",
                      **flags)
    kw = {} if kind == "sync" else dict(sleep_time=sleep_time,
                                        backend_iters=backend_iters)
    saved = os.environ.pop("DROID_ASYNC_PROCESS", None)
    if kind == "process":
        os.environ["DROID_ASYNC_PROCESS"] = "1"
    try:
        droid = make_droid(cfg, device=device, **kw)
    finally:
        os.environ.pop("DROID_ASYNC_PROCESS", None)
        if saved is not None:
            os.environ["DROID_ASYNC_PROCESS"] = saved
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, size=(h, w + 4 * frames, 3)).astype(np.uint8)
    intr = np.array([0.625 * w, 0.625 * w, w / 2, h / 2], np.float32)
    tic = time.perf_counter()
    for t in range(frames):
        droid.track(float(t), _slide_frame(base, t, w), intrinsics=intr)
    cycles = getattr(droid, "backend_cycles", 0)
    stream = _slide_stream(base, intr, frames, w)
    if kind == "sync":
        traj = droid.terminate(stream)
    else:
        traj = droid.terminate(stream, join_timeout=join_timeout)
    return traj, cycles, time.perf_counter() - tic, droid


@pytest.fixture(scope="module")
def sync_bench():
    _skip_without_checkpoint()
    return run_bench("sync", frames=E2E["frames"], buffer=E2E["buffer"])[0]


@pytest.mark.parametrize("kind", ["thread", "process"])
def test_async_end_to_end_lands_near_the_synchronous_port(sync_bench, kind):
    from droid_slam_tpu_torch.slam.async_droid import DroidAsync
    from droid_slam_tpu_torch.slam.async_process import DroidAsyncProcess

    traj, cycles, secs, droid = run_bench(kind, **E2E)
    assert isinstance(droid, {"thread": DroidAsync,
                              "process": DroidAsyncProcess}[kind])
    assert traj.shape == sync_bench.shape == (E2E["frames"] // 2, 7)
    assert np.isfinite(traj).all()
    # the last cycle ran over every keyframe, and the backend's video (the
    # filler's) holds each of them
    n = E2E["frames"]
    assert droid.cycles[-1]["t1"] == droid.video.counter == n
    assert droid.video2.counter == n
    assert torch.equal(droid.video2.tstamp[:n].cpu(),
                       droid.video.tstamp[:n].cpu())
    total = len(droid.cycles)
    err = rel_ate(traj, sync_bench)
    print(kind, dict(cycles_before_terminate=cycles, cycles=total,
                     seconds=secs, rel_ate=err))
    assert total >= 1
    assert err <= E2E_ATE_REL
    if kind == "process":
        assert not droid._proc.is_alive() and droid._proc.exitcode == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["thread", "process"])
def test_async_on_cuda_matches_its_backend_driven_by_hand(kind):
    """Both facades on the card (the backend's own CUDA stream; the
    process's CUDA-shared slabs) in LAST_CYCLE's schedule, where the
    backend's only cycle is its last, over every keyframe: the backend's
    poses equal, to REPLAY_POSE_TOL, those of a ``DroidAsyncBackend``
    driven by hand on the default stream from the tracker's final
    keyframes, and the same with no BA step (the control) lands beyond
    that bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    _skip_without_checkpoint()
    traj, cycles, secs, droid = run_bench(kind, device="cuda", **LAST_CYCLE)
    if kind == "thread":
        # on a machine with a second card the backend runs there
        from droid_slam_tpu_torch.slam.async_droid import backend_device
        assert droid.video2.device == backend_device(droid.device)
    gaps = last_cycle_gaps(droid, traj)
    print(kind, "cuda", dict(gaps, backend_device=str(droid.video2.device)))
    assert gaps["pose_gap"] <= REPLAY_POSE_TOL < gaps["control_no_ba"]


def last_cycle_gaps(droid, traj):
    """A facade run in LAST_CYCLE's schedule: its one backend cycle, over
    every keyframe, against a ``DroidAsyncBackend`` driven by hand on the
    default stream from the tracker's final keyframes, with the cycle's
    steps and with none (the control). Asserts the schedule; returns the
    largest pose gaps."""
    from droid_slam_tpu_torch.slam.async_droid import merge_frames
    from droid_slam_tpu_torch.slam.backend import DroidAsyncBackend
    from droid_slam_tpu_torch.slam.droid import f32_matmuls
    from droid_slam_tpu_torch.state.video import DepthVideo

    n, iters = LAST_CYCLE["frames"], LAST_CYCLE["backend_iters"]
    assert traj.shape == (n // 2, 7) and np.isfinite(traj).all()
    assert [(c["t0"], c["t1"]) for c in droid.cycles] == [(0, n)]
    assert droid.video2.counter == n
    assert torch.equal(droid.video2.tstamp[:n].cpu(),
                       droid.video.tstamp[:n].cpu())
    got = droid.video2.poses[:n].cpu()
    gaps = {}
    for steps in (iters, 0):
        cfg = droid.config
        v2 = DepthVideo(cfg.image_size, cfg.buffer, droid.device)
        backend = DroidAsyncBackend(droid.params, v2, cfg)
        with torch.no_grad(), f32_matmuls():
            merge_frames(v2, 0, droid.video.poses[:n].clone(),
                         droid.video.read_frames(0, n))
            edges = backend(steps, normalize=False)
        if steps:
            assert edges == droid.cycles[0]["edges"]
        gaps[steps] = float((v2.poses[:n].cpu() - got).abs().max())
    return dict(pose_gap=gaps[iters], control_no_ba=gaps[0])


def test_process_backend_failure_raises_in_the_tracker(tmp_path):
    """A backend process that fails (here: its weights file is gone by the
    time it starts) surfaces as an exception in terminate(), with the
    backend's traceback, and has exited non-zero."""
    import shutil

    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.slam.async_process import DroidAsyncProcess

    _skip_without_checkpoint()
    path = str(tmp_path / "weights.npz")
    shutil.copy(CKPT, path)
    droid = DroidAsyncProcess(DroidConfig(buffer=16, image_size=(H, W),
                                          weights=path),
                              sleep_time=0.1, device="cpu")
    os.remove(path)    # the backend process loads it after its start-up
    with pytest.raises(RuntimeError, match="backend process failed") as e:
        droid.terminate(join_timeout=120)
    assert "FileNotFoundError" in str(e.value)
    assert droid._proc.exitcode not in (None, 0)


if __name__ == "__main__":
    # The readings behind E2E_ATE_REL: per texture seed, the relative ATE
    # of each facade to the synchronous port in E2E's schedule, and of a
    # second synchronous run to the first ("sync_again": 0 where the device
    # computes deterministically). DEVICE=cuda takes them on the card.
    device = os.environ.get("DEVICE", "cpu")
    torch.set_num_threads(int(os.environ.get("THREADS", "2")))
    for seed in [int(a) for a in sys.argv[1:]] or [0]:
        sync, again = (run_bench("sync", seed, frames=E2E["frames"],
                                 buffer=E2E["buffer"], device=device)[0]
                       for _ in range(2))
        out = {"sync_again": round(float(rel_ate(again, sync)), 4)}
        for kind in ("thread", "process"):
            traj, cycles, secs, droid = run_bench(kind, seed, device=device,
                                                  **E2E)
            out[kind] = dict(rel_ate=round(float(rel_ate(traj, sync)), 4),
                             cycles_before=cycles, cycles=len(droid.cycles),
                             seconds=round(secs, 1))
        print(device, seed, out, flush=True)
