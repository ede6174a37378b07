"""The global BA's proposal at the presets' buffer sizes, against the JAX
package: the chunked frame distance, the proximity proposal over all t^2
pairs, a backend pass without normalization, ``tools/bench_global_ba_torch.py``
end to end on the CPU, and the frontend's dirty flags.

The videos are the tool's synthetic keyframe video
(``bench_global_ba_torch.synthetic_video``) and the JAX video that
``tools/bench_global_ba.py`` builds from the same draws. The chunk sizes of
both packages' ``DepthVideo.distance`` are forced small with ``monkeypatch``
so that a 40-frame video crosses several chunks.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "checkpoints", "r5_006000.npz")
CHUNK = 256


def _tool():
    spec = importlib.util.spec_from_file_location(
        "bench_global_ba_torch",
        os.path.join(ROOT, "tools", "bench_global_ba_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the TartanAir evaluation settings of both tools
BACKEND = _tool().BACKEND


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several test processes at once,
    and PyTorch's CPU kernels slow down many times over when their threads
    outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _need_checkpoint():
    if not os.path.exists(CKPT):
        pytest.skip(f"needs the trained checkpoint {CKPT}")


def _jax_video(t, image_size):
    """JAX's keyframe video as tools/bench_global_ba.py builds it."""
    import jax.numpy as jnp
    from droid_slam_tpu.data.synthetic import (poses_c2w_from_mats,
                                               random_trajectory)
    from droid_slam_tpu.lie import se3
    from droid_slam_tpu.state.video import DepthVideo

    H, W = image_size
    h, w = H // 8, W // 8
    rng = np.random.default_rng(0)
    video = DepthVideo(image_size=(H, W), buffer=t + 8)
    Rs, ts = random_trajectory(t, rng, step=0.04, rot_step=0.01)
    poses_w2c = np.asarray(se3.inv(jnp.asarray(poses_c2w_from_mats(Rs, ts))))
    B = video.buf.poses.shape[0]
    pad = np.broadcast_to(np.asarray(se3.identity()), (B - t, 7))
    video.buf = video.buf._replace(
        tstamp=jnp.arange(B, dtype=jnp.float32),
        poses=jnp.asarray(np.concatenate([poses_w2c, pad],
                                         axis=0).astype(np.float32)),
        disps=jnp.asarray(
            rng.uniform(0.8, 1.2, size=(B, h, w)).astype(np.float32)),
        intrinsics=jnp.broadcast_to(
            jnp.asarray([0.8 * w, 0.8 * w, w / 2, h / 2], jnp.float32),
            (B, 4)).copy(),
        fmaps=jnp.asarray(rng.normal(size=video.buf.fmaps.shape)
                          .astype(np.float32), jnp.bfloat16),
        nets=jnp.asarray(rng.normal(size=video.buf.nets.shape)
                         .astype(np.float32) * 0.1, jnp.bfloat16),
        inps=jnp.asarray(rng.normal(size=video.buf.inps.shape)
                         .astype(np.float32) * 0.1, jnp.bfloat16),
    )
    video.counter = t
    video.dirty[:t] = True
    return video


def _pairs(t):
    ii, jj = np.meshgrid(np.arange(t), np.arange(t), indexing="ij")
    return ii.reshape(-1), jj.reshape(-1)


@pytest.fixture(scope="module")
def videos40():
    """The tool's 40-frame video at 384x512 (48x64 features) and JAX's."""
    size = (384, 512)
    return _tool().synthetic_video(40, size, "cpu"), _jax_video(40, size)


def test_tool_video_is_the_jax_tools_video(videos40):
    """The same draws in the same order: poses to f32 rounding of the
    inverse, every other field bit for bit."""
    tv, jv = videos40
    b = jv.buf
    assert tv.counter == jv.counter == 40 and tv.buffer == 48
    np.testing.assert_allclose(tv.poses.numpy(), np.asarray(b.poses),
                               atol=1e-6)
    for name in ("tstamp", "disps", "intrinsics"):
        np.testing.assert_array_equal(getattr(tv, name).numpy(),
                                      np.asarray(getattr(b, name)))
    np.testing.assert_array_equal(
        tv.fmaps.float().numpy(),
        np.asarray(b.fmaps, np.float32).transpose(0, 1, 4, 2, 3))
    for name in ("nets", "inps"):
        np.testing.assert_array_equal(
            getattr(tv, name).float().numpy(),
            np.asarray(getattr(b, name), np.float32).transpose(0, 3, 1, 2))


def test_chunked_distance_equals_unchunked_and_jax(videos40, monkeypatch):
    """1600 pairs at 48x64 in chunks of 256: ceil(1600/256) = 7 calls of
    frame_distance, a result equal bit for bit to one call over every pair
    (the distance is computed per pair), and JAX's chunked distance to
    1e-5 relative (f32 sums of 3072 pixels in another order) on every pair
    of two frames."""
    from droid_slam_tpu.state.video import DepthVideo as JVideo
    from droid_slam_tpu_torch.geom import distance as gdist
    from droid_slam_tpu_torch.state.video import DepthVideo as TVideo

    tv, jv = videos40
    ii, jj = _pairs(40)
    whole = tv.distance(ii, jj, beta=0.3)
    assert TVideo._DIST_CHUNK == JVideo._DIST_CHUNK == 32768

    calls = []
    orig = gdist.frame_distance

    def counted(poses, disps, intr, i, j, *a, **k):
        calls.append(len(i))
        return orig(poses, disps, intr, i, j, *a, **k)

    monkeypatch.setattr(gdist, "frame_distance", counted)
    monkeypatch.setattr(TVideo, "_DIST_CHUNK", CHUNK)
    monkeypatch.setattr(JVideo, "_DIST_CHUNK", CHUNK)
    chunked = tv.distance(ii, jj, beta=0.3)
    assert calls == [CHUNK] * 6 + [1600 - 6 * CHUNK]
    assert chunked.shape == (1600,)
    assert torch.equal(chunked, whole)

    want = np.asarray(jv.distance(ii, jj, beta=0.3))
    # a frame's distance to itself is f32 noise around 0 (read 1.7e-5 at
    # most): that is what the 1e-5 px of atol admits, and nothing else
    np.testing.assert_allclose(chunked.numpy(), want, rtol=1e-5, atol=1e-5)
    off = ii != jj
    np.testing.assert_allclose(chunked.numpy()[off], want[off], rtol=1e-5)
    # the proposal's range: distances below the threshold and the 1000
    # sentinel of pairs that see too little of each other
    assert (want < BACKEND["backend_thresh"]).sum() > 40


@pytest.mark.parametrize("max_factors", [16 * 40, 300])
def test_proximity_proposal_over_all_pairs_equals_jax(max_factors,
                                                      monkeypatch):
    """The backend's proposal (rad 2, nms 3, thresh 20) over all 40^2 pairs
    of the tool's video at 240x320, both chunk sizes at 256: the same
    (ii, jj), in the same order, as JAX's (its plan builder in C++), with
    the backend's cap of 16 t edges and with a cap of 300 that stops the
    walk early."""
    from droid_slam_tpu.models import nets as jnets
    from droid_slam_tpu.state.graph import FactorGraph as JGraph
    from droid_slam_tpu.state.video import DepthVideo as JVideo
    from droid_slam_tpu_torch.models import weights as tweights
    from droid_slam_tpu_torch.state.graph import FactorGraph as TGraph
    from droid_slam_tpu_torch.state.video import DepthVideo as TVideo
    import jax

    monkeypatch.setattr(TVideo, "_DIST_CHUNK", CHUNK)
    monkeypatch.setattr(JVideo, "_DIST_CHUNK", CHUNK)
    t, size = 40, (240, 320)
    tv, jv = _tool().synthetic_video(t, size, "cpu"), _jax_video(t, size)
    kw = dict(rad=BACKEND["backend_radius"], nms=BACKEND["backend_nms"],
              thresh=BACKEND["backend_thresh"], beta=BACKEND["beta"])
    tg = TGraph(tv, tweights.init_params(0), max_factors=max_factors,
                corr_impl="alt")
    tg.add_proximity_factors(**kw)
    jg = JGraph(jv, jnets.init_params(jax.random.PRNGKey(0)),
                corr_impl="alt", max_factors=max_factors)
    jg.add_proximity_factors(**kw)
    got = list(zip(tg.ii.tolist(), tg.jj.tolist()))
    want = list(zip(np.asarray(jg.ii).tolist(), np.asarray(jg.jj).tolist()))
    assert got == want
    # proximity edges beyond the 2 x 3 neighbours of each frame (228), and
    # with the small cap the walk stopped at it
    assert len(got) > 228
    if max_factors == 300:
        assert len(got) == 302


def test_backend_pass_without_normalization_matches_jax():
    """``DroidBackend(steps=1, normalize=False)`` in both packages from the
    tool's 24-frame video at 64x96 with its disparities doubled, so that a
    pass that normalized would halve them and part from JAX's by ~50%: the
    same edge list, and poses and disparities to the tolerances of
    test_torch_terminate.py::test_backend_pass_matches_jax_from_the_same_state."""
    _need_checkpoint()
    from droid_slam_tpu.config import DroidConfig as JConfig
    from droid_slam_tpu.models import weights as jweights
    from droid_slam_tpu.slam.backend import DroidBackend as JBackend
    from droid_slam_tpu.state.graph import FactorGraph as JGraph
    from droid_slam_tpu_torch.config import DroidConfig as TConfig
    from droid_slam_tpu_torch.models import weights as tweights
    from droid_slam_tpu_torch.slam.backend import DroidBackend as TBackend
    from droid_slam_tpu_torch.state.graph import FactorGraph as TGraph

    t, size = 24, (64, 96)
    tv, jv = _tool().synthetic_video(t, size, "cpu"), _jax_video(t, size)
    tv.disps *= 2.0
    jv.buf = jv.buf._replace(disps=jv.buf.disps * 2.0)
    p0, d0 = tv.poses[:t].clone().numpy(), tv.disps[:t].clone().numpy()
    cfg = dict(buffer=t + 8, image_size=size, **BACKEND)
    seen = {}

    def spy(key, orig):
        def f(self, *a, **k):
            seen[key] = sorted(zip(np.asarray(self.ii).tolist(),
                                   np.asarray(self.jj).tolist()))
            return orig(self, *a, **k)
        return f

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JGraph, "update_lowmem", spy("jax", JGraph.update_lowmem))
        mp.setattr(TGraph, "update_lowmem",
                   spy("torch", TGraph.update_lowmem))
        JBackend(jweights.load(CKPT), jv, JConfig(**cfg))(
            steps=1, normalize=False)
        n_edges = TBackend(tweights.load(CKPT, "cpu"), tv, TConfig(**cfg))(
            steps=1, normalize=False)
    assert seen["torch"] == seen["jax"] and n_edges == len(seen["jax"])
    assert n_edges > 2 * t

    jp = np.asarray(jv.buf.poses[:t])
    jd = np.asarray(jv.buf.disps[:t], np.float32)
    tp, td = tv.poses[:t].numpy(), tv.disps[:t].numpy()
    moved = np.abs(jp - p0).max()
    gap = np.abs(tp - jp).max()
    dgap = np.median(np.abs(td - jd) / jd)
    print("backend pass, normalize=False", dict(
        pose_moved=moved, pose_gap=gap, disp_median_gap=dgap,
        mean_disp=float(td.mean()), mean_disp_before=float(d0.mean())))
    assert moved > 1e-3
    assert gap <= 0.1 * moved + 1e-4
    assert dgap <= 0.02


def test_tool_runs_end_to_end_on_the_cpu(capsys, monkeypatch):
    """``--t 24 --height 64 --width 96 --steps 1 1 --device cpu``: one JSON
    line with every key, a healthy state and edges in both passes. The
    sweep's cap is lowered to ~64 edges a chunk, which at 64x96 would
    otherwise hold every edge in one chunk, so that the chunk probe counts
    several."""
    _need_checkpoint()
    from droid_slam_tpu_torch.state import graph as graph_mod
    monkeypatch.setattr(graph_mod, "SWEEP_EDGE_PIXELS", 64 * 8 * 12)
    result = _tool().main(["--t", "24", "--height", "64", "--width", "96",
                           "--steps", "1", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == json.loads(
        json.dumps(result))
    for key in ("metric", "value", "step_times_s", "stages", "graph",
                "health", "memory", "device"):
        assert key in result, key
    assert result["metric"] == "global_ba_step_time_t24_64x96"
    assert len(result["step_times_s"]) == 2 and result["value"] > 0
    stages = result["stages"]
    assert stages["setup_s"] > 0
    for i in range(2):
        p = stages[f"pass{i}"]
        for key in ("distance_s", "nms_walk_s", "sweep_s", "ba_s"):
            assert p[key] >= 0, (i, key)
        assert p["normalize"] == (i == 0)
    g = result["graph"]
    assert g["n_edges"] > 0 and stages["pass0"]["edges"] > 0
    assert g["dist_chunks"] == 1 and g["n_chunks"] >= 3
    assert 0 < g["max_chunk"] <= g["n_edges"]
    h = result["health"]
    assert h["poses_finite"] and h["disps_finite_pos"]
    assert h["quat_norm_max_err"] < 1e-5
    assert set(result["memory"]) == {"peak_allocated_gib",
                                     "peak_reserved_gib"}
    assert result["device"]["name"] == "cpu"


def test_tool_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    """Without ``--device`` on a host without CUDA the tool exits with
    require_device's message before it builds anything."""
    tool = _tool()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_work(*a, **k):
        raise AssertionError("the tool ran before the device check")

    monkeypatch.setattr(tool, "run", no_work)
    monkeypatch.setattr(tool, "synthetic_video", no_work)
    with pytest.raises(SystemExit) as e:
        tool.main(["--t", "24", "--height", "64", "--width", "96"])
    assert "CUDA is not available" in str(e.value)
    assert "--device cpu" in str(e.value)


def test_frontend_marks_frames_dirty_as_jax_does():
    """The frontend's initialization marks frames [0, t1) dirty, and each
    update [min(ii), t1), in both packages: the tool's 9-frame video at
    64x96, the initialization at 8 keyframes and one update after the 9th,
    each started from cleared flags."""
    _need_checkpoint()
    from droid_slam_tpu.config import DroidConfig as JConfig
    from droid_slam_tpu.models import weights as jweights
    from droid_slam_tpu.slam.frontend import DroidFrontend as JFrontend
    from droid_slam_tpu_torch.config import DroidConfig as TConfig
    from droid_slam_tpu_torch.models import weights as tweights
    from droid_slam_tpu_torch.slam.frontend import DroidFrontend as TFrontend

    t, size = 9, (64, 96)
    tv, jv = _tool().synthetic_video(t, size, "cpu"), _jax_video(t, size)
    cfg = dict(buffer=t + 8, image_size=size, warmup=8, frontend_window=16,
               frontend_thresh=16.0, frontend_radius=2, frontend_nms=1)
    tf = TFrontend(tweights.load(CKPT, "cpu"), tv, TConfig(**cfg))
    jf = JFrontend(jweights.load(CKPT), jv, JConfig(**cfg))
    flags = []
    for n in (8, 9):
        for v in (tv, jv):
            v.counter = n
            v.dirty[:] = False
        tf()
        jf()
        flags.append((tv.dirty.copy(), jv.dirty.copy()))
    (t_init, j_init), (t_upd, j_upd) = flags
    np.testing.assert_array_equal(t_init, j_init)
    np.testing.assert_array_equal(t_upd, j_upd)
    assert np.flatnonzero(t_init).tolist() == list(range(8))
    lo = int(tf.graph.ii.min())
    assert np.flatnonzero(t_upd).tolist() == list(range(lo, 9))
