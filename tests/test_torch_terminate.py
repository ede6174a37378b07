"""The port's terminate() path against the JAX package: the alt correlation,
the global BA (``DroidBackend`` / ``update_lowmem``), the trajectory filler
and ``Droid.terminate`` end to end.

Both frameworks run the update operator in bf16 and round at different
places, so single steps are compared closely and whole runs by trajectory
error after alignment (ATE, Umeyama with scale, droid_slam_tpu/eval/ate.py).
The end-to-end test tracks the 14 synthetic frames of
tests/test_torch_slice.py (64x96, the bench's admit-all configuration) in
both, then calls ``terminate(stream=...)`` with the bench's filler stream
(one fresh non-keyframe for every two keyframes) and backend steps (7, 12).

JAX is imported inside the tests and fixtures that use it, so that the CUDA
test runs on a machine without JAX:
    python -m pytest --noconftest -m cuda tests/test_torch_terminate.py
"""

import os

import numpy as np
import pytest
import torch

from droid_slam_tpu_torch.ops import corr as tcorr

H, W = 64, 96
N_FRAMES = 14
CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "r5_006000.npz")
CFG = dict(buffer=32, image_size=(H, W), warmup=8, frontend_window=16,
           frontend_thresh=16.0, frontend_radius=2, frontend_nms=1,
           filter_thresh=-1.0, keyframe_thresh=-1.0)
BACKEND_STEPS = (7, 12)
# Bounds on the ATE between the port's and JAX's trajectories (scene units):
# keyframe poses after the global BA, and the filled poses. Readings on
# seeds 11-16 (run this file as a script): keyframes 0.0042-0.0214, filled
# 0.0048-0.0187 (seed 11, the test's: 0.0042 and 0.0062); for scale, each
# trajectory's own ATE against the ground truth is 0.071-0.195 (JAX) and
# 0.072-0.191 (port). The bounds are 2.3x the largest reading and below the
# smallest error against the ground truth.
ATE_KEYFRAMES = 0.05
ATE_FILLED = 0.05


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several test processes at once,
    and PyTorch's CPU kernels, each process spinning a thread per core,
    slow down many times over when they outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _frames(seed=11):
    from droid_slam_tpu.data.synthetic import synthetic_stream
    return list(synthetic_stream(n_frames=N_FRAMES, image_size=(H, W),
                                 seed=seed, step=0.12, rot_step=0.04))


def _filler_stream(frames):
    """bench.py's filler stream: one frame at t = k + 0.5 for every two
    keyframes, the image of frame k or k+1."""
    for k in range(0, len(frames), 2):
        img = frames[k if k % 4 else min(k + 1, len(frames) - 1)][1][0]
        yield k + 0.5, img, frames[k][2]


def _skip_without_checkpoint():
    if not os.path.exists(CKPT):
        pytest.skip(f"needs the trained checkpoint {CKPT}: with random "
                    "weights the two pipelines part at the first edge "
                    "proposal")


# ---------------------------------------------------------------------------
# alt correlation
# ---------------------------------------------------------------------------

def test_build_fmap_pyramid_and_alt_lookup_match_jax():
    import jax.numpy as jnp
    from droid_slam_tpu.ops import corr as jcorr

    rng = np.random.default_rng(21)
    N, E, h, w = 5, 6, 8, 12
    fmaps = rng.normal(size=(N, h, w, 128)).astype(np.float32)
    # coordinates reach 3 px past every border: out-of-range taps are zero
    coords = (rng.uniform(size=(E, h, w, 2)) * np.array([w + 6, h + 6])
              - 3).astype(np.float32)
    ii = rng.integers(0, N, size=E)
    jj = (ii + rng.integers(1, N, size=E)) % N

    jpyr = jcorr.build_fmap_pyramid(jnp.asarray(fmaps))
    tpyr = tcorr.build_fmap_pyramid(
        torch.as_tensor(fmaps).permute(0, 3, 1, 2).contiguous())
    assert len(tpyr) == 4
    for t, j in zip(tpyr, jpyr):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)

    want = np.asarray(jcorr.alt_lookup(jpyr, jnp.asarray(coords),
                                       jnp.asarray(ii), jnp.asarray(jj)))
    got = tcorr.alt_lookup(tpyr, torch.as_tensor(coords).reshape(E, -1, 2),
                           torch.as_tensor(ii), torch.as_tensor(jj))
    assert got.shape == (E, h * w, 196) and got.dtype == torch.float32
    # 128-term f32 dot products summed in another order, blended
    np.testing.assert_allclose(got.reshape(E, h, w, 196).numpy(), want,
                               atol=1e-4)
    assert (want == 0).any() and np.abs(want).max() > 1.0


def test_alt_lookup_equals_the_volume_lookup():
    """The alt correlation is the volume lookup without the volume: the same
    windows from the f32 pyramid of the edges' correlation volumes."""
    rng = np.random.default_rng(22)
    N, E, h, w = 4, 5, 8, 12
    fmaps = torch.as_tensor(rng.normal(size=(N, 128, h, w))
                            .astype(np.float32))
    ii = torch.as_tensor(rng.integers(0, N, size=E))
    jj = (ii + torch.as_tensor(rng.integers(1, N, size=E))) % N
    coords = torch.as_tensor((rng.uniform(size=(E, h * w, 2))
                              * np.array([w + 4, h + 4]) - 2)
                             .astype(np.float32))
    alt = tcorr.alt_lookup(tcorr.build_fmap_pyramid(fmaps), coords, ii, jj)
    vol = tcorr.lookup_pyramid_plain(
        tcorr.build_pyramid(fmaps[ii], fmaps[jj]),
        torch.arange(E, dtype=torch.int32), coords)
    # pooling the features and pooling the volume commute; f32 sums
    torch.testing.assert_close(alt, vol, atol=1e-4, rtol=1e-5)


# ---------------------------------------------------------------------------
# the global BA's update operator: update_module without the precompute
# ---------------------------------------------------------------------------

def test_update_module_without_pre_matches_jax_in_bf16():
    """The call of the global BA's chunk sweep: the full 320-channel context
    path in bf16, aggregated over the 8 source frames of a chunk."""
    import jax.numpy as jnp
    from droid_slam_tpu.models import nets as jnets
    from droid_slam_tpu_torch.models import nets as tnets
    from droid_slam_tpu_torch.models import weights as tweights

    _skip_without_checkpoint()
    with np.load(CKPT) as d:
        jparams = {k: d[k] for k in d.files}
    rng = np.random.default_rng(23)
    E, h, w = 5, 8, 12
    net = np.tanh(rng.normal(size=(E, h, w, 128))).astype(np.float32)
    inp = np.maximum(rng.normal(size=(E, h, w, 128)), 0).astype(np.float32)
    corr = rng.normal(size=(E, h, w, 196)).astype(np.float32)
    flow = (4 * rng.normal(size=(E, h, w, 4))).astype(np.float32)
    ii = np.array([0, 0, 3, 5, 7])
    bf = jnp.bfloat16
    want = jnets.update_module(
        {k: jnp.asarray(v) for k, v in jparams.items()},
        *(jnp.asarray(a, bf) for a in (net, inp, corr, flow)),
        ii=jnp.asarray(ii), num_frames=9)
    nchw = lambda a: torch.as_tensor(a).permute(0, 3, 1, 2).to(
        torch.bfloat16).contiguous()
    got = tnets.update_module(
        tweights.from_jax_params(jparams), *map(nchw, (net, inp, corr, flow)),
        ii=torch.as_tensor(ii), num_frames=8)
    # bf16 convolutions (one ulp of their outputs) through the GRU and the
    # two heads: the state to 3e-2 (tests/test_gru_pallas.py's bf16 bound),
    # the flow delta and weight to 3e-2 of their range, eta to 2%
    for g, w_, tol in zip(got[:3], want[:3], (3e-2, 3e-2, 3e-2)):
        w_ = np.asarray(w_, np.float32)
        np.testing.assert_allclose(
            g.float().permute(0, 2, 3, 1).numpy(), w_,
            atol=tol * max(np.abs(w_).max(), 1.0))
    np.testing.assert_allclose(got[3].float().numpy(),
                               np.asarray(want[3][:8], np.float32),
                               rtol=2e-2, atol=1e-6)


# ---------------------------------------------------------------------------
# end-to-end runs, shared by the tests below
# ---------------------------------------------------------------------------

_BF16_FIELDS = ("fmaps", "nets", "inps")


def _snapshot_jax(droid):
    """The JAX video's buffers as f32 numpy (bf16 fields widened exactly)."""
    buf = droid.video.buf
    return dict({k: np.asarray(v, np.float32)
                 for k, v in buf._asdict().items()},
                counter=droid.video.counter)


def _jax_video(snap, buffer=None):
    import jax.numpy as jnp
    from droid_slam_tpu.state.video import DepthVideo, VideoBuffers
    B = buffer or len(snap["tstamp"])
    v = DepthVideo((H, W), B)
    v.buf = VideoBuffers(**{
        k: jnp.asarray(snap[k][:B],
                       jnp.bfloat16 if k in _BF16_FIELDS else jnp.float32)
        for k in VideoBuffers._fields})
    v.counter = snap["counter"]
    return v


def _torch_video(snap, buffer=None, device="cpu"):
    from droid_slam_tpu_torch.state.video import DepthVideo
    B = buffer or len(snap["tstamp"])
    v = DepthVideo((H, W), B, device)
    for name in ("tstamp", "poses", "disps", "intrinsics", "damping"):
        getattr(v, name).copy_(torch.as_tensor(snap[name][:B]))
    for name in ("nets", "inps"):
        getattr(v, name).copy_(torch.as_tensor(snap[name][:B])
                               .permute(0, 3, 1, 2))
    v.fmaps.copy_(torch.as_tensor(snap["fmaps"][:B]).permute(0, 1, 4, 2, 3))
    v.counter = snap["counter"]
    return v


def _run_jax(frames):
    """JAX track -> flush -> terminate(stream); the video state after the
    flush, the backend passes' edge lists, the keyframe poses after the
    global BA and the filled trajectory."""
    from droid_slam_tpu.config import DroidConfig
    from droid_slam_tpu.slam import Droid
    from droid_slam_tpu.state.graph import FactorGraph

    droid = Droid(DroidConfig(**CFG, weights=CKPT))
    for t, img, intr in frames:
        droid.track(float(t), img[0], intrinsics=intr)
    droid.flush()
    snap = _snapshot_jax(droid)
    edges, orig = [], FactorGraph.update_lowmem

    def spy(self, *a, **k):
        edges.append(sorted(zip(self.ii.tolist(), self.jj.tolist())))
        return orig(self, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FactorGraph, "update_lowmem", spy)
        traj = droid.terminate(stream=_filler_stream(frames),
                               backend_steps=BACKEND_STEPS)
    n = droid.video.counter
    return dict(snap=snap, params=droid.params, edges=edges, filled=traj,
                tstamps=np.asarray(droid.video.buf.tstamp[:n]).tolist(),
                keyframes=np.asarray(droid.video.buf.poses[:n]))


def _run_torch(frames, device="cpu", fused=False):
    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.slam.droid import Droid
    from droid_slam_tpu_torch.state.graph import FactorGraph

    droid = Droid(DroidConfig(**CFG, weights=CKPT, gru_fused_epilogue=fused),
                  device=device)
    for t, img, intr in frames:
        droid.track(float(t), img[0], intrinsics=intr)
    edges, orig = [], FactorGraph.update_lowmem

    def spy(self, *a, **k):
        edges.append(sorted(zip(self.ii.tolist(), self.jj.tolist())))
        return orig(self, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FactorGraph, "update_lowmem", spy)
        traj = droid.terminate(stream=_filler_stream(frames),
                               backend_steps=BACKEND_STEPS)
    n = droid.video.counter
    return dict(edges=edges, filled=traj, stats=droid.terminate_stats,
                tstamps=droid.video.tstamp[:n].tolist(),
                keyframes=droid.video.poses[:n].cpu().numpy())


def _c2w_xyz(poses_w2c):
    from droid_slam_tpu_torch.lie import se3
    return se3.inv(torch.as_tensor(np.array(poses_w2c))).numpy()[:, :3]


def _ates(got, ref):
    """ATE (scaled alignment) of the port's keyframe and filled
    trajectories against the reference's."""
    from droid_slam_tpu.eval.ate import ate_rmse
    return dict(
        keyframes=ate_rmse(_c2w_xyz(got["keyframes"]),
                           _c2w_xyz(ref["keyframes"]))[0],
        filled=ate_rmse(got["filled"][:, :3], ref["filled"][:, :3])[0])


@pytest.fixture(scope="module")
def runs():
    _skip_without_checkpoint()
    frames = _frames()
    return dict(jax=_run_jax(frames), torch=_run_torch(frames))


def test_terminate_matches_jax(runs):
    ref, got = runs["jax"], runs["torch"]
    assert got["tstamps"] == ref["tstamps"]
    assert got["filled"].shape == ref["filled"].shape == (N_FRAMES // 2, 7)
    assert np.isfinite(got["filled"]).all()
    assert np.isfinite(got["keyframes"]).all()
    assert len(got["stats"]["backend_s"]) == len(BACKEND_STEPS)
    assert got["stats"]["backend_edges"] == [len(e) for e in got["edges"]]
    ates = _ates(got, ref)
    print("terminate", {k: round(v, 5) for k, v in ates.items()},
          "backend edges", [len(e) for e in got["edges"]],
          [len(e) for e in ref["edges"]])
    assert ates["keyframes"] <= ATE_KEYFRAMES
    assert ates["filled"] <= ATE_FILLED


def test_backend_pass_matches_jax_from_the_same_state(runs):
    """One global-BA pass (normalize, proximity edges, update_lowmem with
    one step) from the JAX package's post-tracking state copied into the
    port: the same edge list, and poses and disparities to the stated
    tolerances."""
    from droid_slam_tpu.config import DroidConfig as JConfig
    from droid_slam_tpu.slam.backend import DroidBackend as JBackend
    from droid_slam_tpu.state.graph import FactorGraph as JGraph
    from droid_slam_tpu_torch.config import DroidConfig as TConfig
    from droid_slam_tpu_torch.models import weights as tweights
    from droid_slam_tpu_torch.slam.backend import DroidBackend as TBackend
    from droid_slam_tpu_torch.state.graph import FactorGraph as TGraph

    snap = runs["jax"]["snap"]
    jv, tv = _jax_video(snap), _torch_video(snap)
    seen = {}

    def spy(key, orig):
        def f(self, *a, **k):
            seen[key] = sorted(zip(self.ii.tolist(), self.jj.tolist()))
            return orig(self, *a, **k)
        return f

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JGraph, "update_lowmem",
                   spy("jax", JGraph.update_lowmem))
        mp.setattr(TGraph, "update_lowmem",
                   spy("torch", TGraph.update_lowmem))
        JBackend(runs["jax"]["params"], jv, JConfig(**CFG))(steps=1)
        n_edges = TBackend(tweights.load(CKPT, "cpu"), tv,
                           TConfig(**CFG))(steps=1)
    assert seen["torch"] == seen["jax"] and n_edges == len(seen["jax"])
    assert n_edges > 2 * snap["counter"]   # proximity edges beyond neighbours

    n = snap["counter"]
    jp, jd = np.asarray(jv.buf.poses[:n]), np.asarray(jv.buf.disps[:n])
    tp, td = tv.poses[:n].numpy(), tv.disps[:n].numpy()
    before = _torch_video(snap)
    before.normalize()
    moved = np.abs(jp - before.poses[:n].numpy()).max()
    gap = np.abs(tp - jp).max()
    dgap = np.median(np.abs(td - jd) / jd)
    print("backend pass", dict(pose_moved=moved, pose_gap=gap,
                               disp_median_gap=dgap))
    # one bf16 update of every edge (flow deltas differ by ~1 bf16 ulp,
    # ~0.03 px) then 2 Gauss-Newton iterations: the poses move by `moved`
    # and the two frameworks agree to a tenth of that
    assert moved > 1e-3
    assert gap <= 0.1 * moved + 1e-4
    assert dgap <= 0.02


# ---------------------------------------------------------------------------
# the trajectory filler's capacity guard
# ---------------------------------------------------------------------------

def _filler_batch(frames, count):
    items = list(_filler_stream(frames))[:count]
    return tuple(zip(*items))


def test_filler_returns_the_interpolation_when_the_buffer_is_full(runs):
    """With no free slot the filler returns the SE3 interpolation between
    the bracketing keyframes, as the JAX package does."""
    from droid_slam_tpu.slam.trajectory_filler import (
        PoseTrajectoryFiller as JFiller)
    from droid_slam_tpu_torch.slam.trajectory_filler import (
        PoseTrajectoryFiller as TFiller)

    snap = runs["jax"]["snap"]
    n = snap["counter"]
    ts, imgs, intr = _filler_batch(_frames(), 5)
    jv, tv = _jax_video(snap, buffer=n), _torch_video(snap, buffer=n)
    want = JFiller(runs["jax"]["params"], jv)._fill(ts, imgs, intr)
    got = TFiller(None, tv)._fill(ts, imgs, intr)   # no network runs
    assert got.shape == (5, 7) and tv.counter == n
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_filler_splits_a_batch_to_the_free_slots(runs, monkeypatch):
    """With 3 free slots a batch of 5 runs as 3 + 2 temporary frames; the
    result equals the two halves filled on their own."""
    from droid_slam_tpu_torch.models import weights as tweights
    from droid_slam_tpu_torch.slam.trajectory_filler import (
        PoseTrajectoryFiller as TFiller)
    from droid_slam_tpu_torch.state.graph import FactorGraph

    snap = runs["jax"]["snap"]
    n = snap["counter"]
    params = tweights.load(CKPT, "cpu")
    ts, imgs, intr = _filler_batch(_frames(), 5)
    windows, orig = [], FactorGraph.update

    def spy(self, t0=None, t1=None, **k):
        windows.append((t0, t1))
        return orig(self, t0, t1, **k)

    monkeypatch.setattr(FactorGraph, "update", spy)
    tv = _torch_video(snap, buffer=n + 3)
    got = TFiller(params, tv)._fill(ts, imgs, intr)
    assert windows == [(n, n + 3), (n, n + 2)] and tv.counter == n
    assert got.shape == (5, 7) and np.isfinite(got).all()
    alone = _torch_video(snap, buffer=n + 3)
    want = np.concatenate([
        TFiller(params, alone)._fill(ts[:3], imgs[:3], intr[:3]),
        TFiller(params, alone)._fill(ts[3:], imgs[3:], intr[3:])])
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_filler_batches_keep_their_own_poses(runs):
    """A stream longer than one batch of 16: each batch's poses are its
    own. On the CPU ``.numpy()`` of the video's pose rows aliases them, and
    the next batch's temporary frames, written to the same rows, overwrote
    the first batch's result."""
    from droid_slam_tpu_torch.models import weights as tweights
    from droid_slam_tpu_torch.slam.trajectory_filler import (
        PoseTrajectoryFiller as TFiller)

    snap = runs["jax"]["snap"]
    n = snap["counter"]
    params = tweights.load(CKPT, "cpu")
    items = list(_filler_stream(_frames())) * 3     # 21 frames: 16 + 5
    got = TFiller(params, _torch_video(snap, buffer=n + 16))(iter(items))
    alone = [TFiller(params, _torch_video(snap, buffer=n + 16))._fill(
        *zip(*items[a:b])) for a, b in ((0, 16), (16, len(items)))]
    assert got.shape == (len(items), 7)
    np.testing.assert_allclose(got, np.concatenate(alone), atol=1e-6)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_terminate_on_cuda_matches_cpu(fused):
    """The port's terminate on the GPU (CUDA kernels, cuDNN, cuSOLVER)
    against the port on the CPU, with the bounds held against JAX."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    _skip_without_checkpoint()
    frames = _frames()
    got = _run_torch(frames, device="cuda", fused=fused)
    ref = _run_torch(frames, fused=fused)
    assert got["tstamps"] == ref["tstamps"]
    assert np.isfinite(got["filled"]).all()
    ates = _ates(got, ref)
    print("terminate cuda vs cpu", fused, ates)
    assert ates["keyframes"] <= ATE_KEYFRAMES
    assert ates["filled"] <= ATE_FILLED


if __name__ == "__main__":
    # The readings behind the ATE bounds, on other scenes:
    #   PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_terminate.py 11 12
    # For scale, each keyframe trajectory's ATE against the ground truth.
    import sys
    from droid_slam_tpu.data.synthetic import synthetic_groundtruth
    from droid_slam_tpu.eval.ate import ate_rmse
    for seed in [int(a) for a in sys.argv[1:]] or [11]:
        frames = _frames(seed)
        ref, got = _run_jax(frames), _run_torch(frames)
        same = got["tstamps"] == ref["tstamps"]
        gt = synthetic_groundtruth(n_frames=N_FRAMES, image_size=(H, W),
                                   seed=seed, step=0.12, rot_step=0.04)
        vs_gt = {k: ate_rmse(_c2w_xyz(r["keyframes"]),
                             gt[np.asarray(r["tstamps"], int), :3])[0]
                 for k, r in (("jax", ref), ("port", got))}
        print(seed, f"keyframes {len(ref['tstamps'])}",
              "same keyframes" if same else "keyframes differ",
              "backend edges", [len(e) for e in got["edges"]],
              [len(e) for e in ref["edges"]],
              "same edges" if got["edges"] == ref["edges"] else
              "edges differ", _ates(got, ref) if same else "",
              "vs ground truth", vs_gt, flush=True)
