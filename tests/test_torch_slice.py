"""The port's tracking slice against the JAX package, end to end.

The same 14 synthetic frames (64x96, so 8x12 features at full network
width) go through JAX ``Droid.track`` (CPU: per-call path, gather lookup)
and the port's ``Droid(cfg, device="cpu").track``, then ``flush()``.
Keyframe timestamps and edge lists must be equal. Poses and disparities
agree only to a tolerance: both frameworks run the update operator in bf16
and round at different places (one bf16 ulp in a delta is ~0.03 px), and
the 2x8 initialization iterations amplify that chaotically (the JAX
package against itself, with only its lookup formulation changed from
gather to tent, differs by the same order). Measured on these frames (run
with -s to print): poses within 0.018 (scene translations up to 0.5),
per-frame mean disparity within 12%. The bounds below are about 3x that.

The mean alone would pass a field of the right mean and the wrong shape,
so two spatial statistics are held too: the median over all keyframes and
pixels of |d_port - d_jax| / d_jax, and for each keyframe the correlation
of the two fields over its pixels. Readings on six scenes (synthetic seeds
11-16, both configurations, 12 runs): median 0.056-0.119, correlation at
least 0.742 in every keyframe; the reference against itself flipped
left-right reads a median of 0.63-0.98 and a correlation below 0 (run this
file as a script to print both). Bounds: median 0.25, correlation 0.5.

Two configurations: the bench's (every frame admitted and kept, so the
edge cap and the age-based eviction decide the graph), and one with
thresholds that reject a frame and drop keyframes; its thresholds sit at
least 0.04 (admission) and 0.07 (keyframe distance) away from every value
the two pipelines compute on these frames, well above their ~0.003 and
~0.03 disagreement.

The bench's configuration runs a second time with the ConvGRU's fused gate
epilogues: ``gru_fused_epilogue=True`` in the port, ``DROID_GRU_PALLAS=
interpret`` in JAX. JAX reads that flag once at import and does not key its
jit caches on it, so its run goes into a subprocess of its own.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

H, W = 64, 96
N_FRAMES = 14
CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "r5_006000.npz")
CONFIGS = {
    "admit_all": dict(filter_thresh=-1.0, keyframe_thresh=-1.0),
    "reject_and_drop": dict(filter_thresh=0.9, keyframe_thresh=0.3),
}


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


def _cfg_kwargs(name, weights):
    return dict(buffer=32, image_size=(H, W), warmup=8,
                frontend_window=16, frontend_thresh=16.0, frontend_radius=2,
                frontend_nms=1, weights=weights, **CONFIGS[name])


@pytest.fixture(scope="module")
def weights():
    """The trained checkpoint. With random weights the flow estimates carry
    no signal, every edge proposal sits at a threshold, and the two bf16
    pipelines part at the first of them: there is nothing to compare."""
    if not os.path.exists(CKPT):
        pytest.skip(f"needs the trained checkpoint {CKPT}")
    return CKPT


def _run_jax(name, frames, weights):
    from droid_slam_tpu.config import DroidConfig
    from droid_slam_tpu.slam import Droid

    droid = Droid(DroidConfig(**_cfg_kwargs(name, weights)))
    for t, img, intr in frames:
        droid.track(float(t), img[0], intrinsics=intr)
    droid.flush()
    n, g, buf = droid.video.counter, droid.frontend.graph, droid.video.buf
    return dict(tstamps=np.asarray(buf.tstamp[:n]).tolist(),
                edges=sorted(zip(g.ii.tolist(), g.jj.tolist())),
                poses=np.asarray(buf.poses[:n]),
                disps=np.asarray(buf.disps[:n]))


def _run_jax_fused(name, seed, weights, tmp_path):
    """_run_jax with the Pallas GRU epilogues (interpret mode), in a fresh
    process."""
    out = os.path.join(str(tmp_path), f"jax_fused_{name}_{seed}.npz")
    code = ("import sys, numpy as np\n"
            f"sys.path.insert(0, {os.path.dirname(__file__)!r})\n"
            "import test_torch_slice as s\n"
            f"r = s._run_jax({name!r}, s._frames({seed}), {weights!r})\n"
            f"np.savez({out!r}, tstamps=r['tstamps'], edges=r['edges'], "
            "poses=r['poses'], disps=r['disps'])\n")
    env = dict(os.environ, DROID_GRU_PALLAS="interpret", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as d:
        return dict(tstamps=d["tstamps"].tolist(),
                    edges=[tuple(e) for e in d["edges"].tolist()],
                    poses=d["poses"], disps=d["disps"])


def _run_torch(name, frames, weights, device="cpu", fused=False):
    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.slam.droid import Droid

    droid = Droid(DroidConfig(**_cfg_kwargs(name, weights),
                              gru_fused_epilogue=fused), device=device)
    for t, img, intr in frames:
        droid.track(float(t), img[0], intrinsics=intr)
    droid.flush()
    n, g, v = droid.video.counter, droid.frontend.graph, droid.video
    return dict(tstamps=v.tstamp[:n].tolist(),
                edges=sorted(zip(g.ii.tolist(), g.jj.tolist())),
                poses=v.poses[:n].cpu().numpy(),
                disps=v.disps[:n].cpu().numpy())


def _gaps(got, ref):
    """Largest pose gap, largest per-frame relative gap of the mean
    disparity, median over keyframes and pixels of the relative disparity
    gap, and the least per-keyframe correlation of the disparity fields."""
    mean_got = got["disps"].mean(axis=(1, 2))
    mean_ref = ref["disps"].mean(axis=(1, 2))
    g, r = (d.reshape(len(d), -1) for d in (got["disps"], ref["disps"]))
    g, r = g - g.mean(1, keepdims=True), r - r.mean(1, keepdims=True)
    corr = (g * r).sum(1) / np.sqrt((g * g).sum(1) * (r * r).sum(1))
    return dict(
        pose=float(np.abs(got["poses"] - ref["poses"]).max()),
        mean=float((np.abs(mean_got - mean_ref) / mean_ref).max()),
        median=float(np.median(np.abs(got["disps"] - ref["disps"])
                               / ref["disps"])),
        corr=float(corr.min()))


def _assert_same_track(got, ref, name):
    assert got["tstamps"] == ref["tstamps"]
    assert got["edges"] == ref["edges"]
    assert len(ref["edges"]) > 0
    if name == "reject_and_drop":
        assert len(ref["tstamps"]) < N_FRAMES   # decisions were exercised

    assert np.isfinite(got["poses"]).all() and np.isfinite(got["disps"]).all()
    gaps = _gaps(got, ref)
    print(name, {k: round(v, 4) for k, v in gaps.items()})
    np.testing.assert_allclose(got["poses"], ref["poses"], atol=0.05)
    np.testing.assert_allclose(got["disps"].mean(axis=(1, 2)),
                               ref["disps"].mean(axis=(1, 2)), rtol=0.35)
    assert gaps["median"] <= 0.25
    assert gaps["corr"] >= 0.5


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_track_slice_matches_jax(name, weights):
    frames = _frames()
    _assert_same_track(_run_torch(name, frames, weights),
                       _run_jax(name, frames, weights), name)


def test_track_slice_with_fused_gru_epilogues_matches_jax(weights,
                                                         tmp_path):
    """The port's fused epilogues (their plain twins, on the CPU) against
    the JAX package's Pallas epilogues in interpret mode."""
    frames = _frames()
    _assert_same_track(_run_torch("admit_all", frames, weights, fused=True),
                       _run_jax_fused("admit_all", 11, weights, tmp_path),
                       "admit_all")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_track_slice_on_cuda_matches_cpu(name, weights):
    """The GPU path (CUDA lookup kernel, cuDNN bf16 convolutions, cuSOLVER)
    against the CPU path of the port, with the same bounds: the two differ
    by bf16 rounding and by the order of atomic sums, as the CPU port and
    JAX do."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    frames = _frames()
    _assert_same_track(_run_torch(name, frames, weights, device="cuda"),
                       _run_torch(name, frames, weights), name)


if __name__ == "__main__":
    # The readings behind the bounds, on other scenes:
    #   PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_slice.py 11 12
    import sys
    for seed in [int(a) for a in sys.argv[1:]] or [11]:
        frames = _frames(seed)
        for name in sorted(CONFIGS):
            got = _run_torch(name, frames, CKPT)
            ref = _run_jax(name, frames, CKPT)
            same = (got["tstamps"] == ref["tstamps"]
                    and got["edges"] == ref["edges"])
            print(seed, name, f"keyframes {len(ref['tstamps'])}",
                  "same graph" if same else "graphs differ",
                  _gaps(got, ref) if got["tstamps"] == ref["tstamps"] else "",
                  flush=True)
            # a field of the right mean and the wrong shape, for contrast
            flipped = dict(ref, disps=ref["disps"][:, :, ::-1])
            print(seed, name, "flipped left-right", _gaps(flipped, ref),
                  flush=True)
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            ref = _run_jax_fused("admit_all", seed, CKPT, tmp)
        got = _run_torch("admit_all", frames, CKPT, fused=True)
        same = (got["tstamps"] == ref["tstamps"]
                and got["edges"] == ref["edges"])
        print(seed, "admit_all fused", "same graph" if same else
              "graphs differ",
              _gaps(got, ref) if got["tstamps"] == ref["tstamps"] else "",
              flush=True)
