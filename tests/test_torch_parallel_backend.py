"""The port's chunk-parallel global BA (``parallel/backend.py`` through
``FactorGraph(mesh=...).update_lowmem``) against its serial sweep, and the
asynchronous backend's device.

One global-BA step over tools/bench_global_ba_torch.py's synthetic video
(32 keyframes at 64x96, the trained weights, the backend's proposal) on
``Mesh(["cpu"] * n)``, n = 2, 3 and 4: the sweep covers 4 chunks of 8
source frames, so n = 3 leaves the shards uneven. Held to the serial step
at the tolerances of JAX's ``test_mesh_lowmem_matches_resident``
(tests/test_lowmem_spill.py:107-131); also with the inactive edges of a
persistent graph in the BA. With ``upsample`` the mesh graph takes the
serial sweep (droid_slam_tpu/state/graph.py:1297) and equals the serial
graph bit for bit.

The same mesh step against JAX's (``parallel/backend.py::
lowmem_step_mesh`` on 2 and 3 of the conftest's virtual CPU devices) from
JAX's copy of the video (test_torch_backend_scale.py::_jax_video, the
same draws): the same edges, and poses and disparities to the bounds of
test_torch_backend_scale.py's port-against-JAX global-BA pass (largest
pose gap within a tenth of the step's largest pose move plus 1e-4, median
relative disparity gap 0.02; readings 3.1e-4 against 6.5e-3, and 1.9e-3).
The frameworks' own distance dominates those gaps, so the mesh's share
is held apart: the mesh runs' gaps may exceed the serial runs' by no more
than JAX's mesh-against-serial bounds (poses 2e-4, disparities 2e-3).
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from droid_slam_tpu_torch.parallel import backend as pback
from droid_slam_tpu_torch.parallel.mesh import Mesh
from droid_slam_tpu_torch.slam import async_droid
from droid_slam_tpu_torch.state.graph import FactorGraph

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "checkpoints", "r5_006000.npz")
T, SIZE = 32, (64, 96)
# JAX's tests/test_lowmem_spill.py:121-131, (rtol, atol)
TOL = {"poses": (2e-4, 2e-4), "disps": (2e-3, 2e-3),
       "damping": (2e-3, 1e-6), "target": (2e-3, 2e-3),
       "weight": (2e-2, 2e-3), "net": (2e-2, 2e-2)}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    from droid_slam_tpu_torch.models import weights as tweights
    if not os.path.exists(CKPT):
        pytest.skip(f"needs the trained checkpoint {CKPT}")
    return tweights.load(CKPT, "cpu")


def _video(device="cpu"):
    spec = importlib.util.spec_from_file_location(
        "bench_global_ba_torch",
        os.path.join(ROOT, "tools", "bench_global_ba_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool.synthetic_video(T, SIZE, device)


def _step(params, mesh, inactive=False, upsample=False, device="cpu"):
    """One update_lowmem step; the state it leaves, on the host."""
    video = _video(device)
    if upsample:
        video.disps_up = torch.zeros((video.buffer,) + SIZE, device=device)
    g = FactorGraph(video, params, max_factors=16 * T, corr_impl="alt",
                    upsample=upsample, mesh=mesh)
    g.add_proximity_factors(rad=2, nms=3, thresh=22.0, beta=0.3)
    if inactive:
        g.rm_factors(g.ii < 6, store=True)
    with torch.no_grad():
        g.update_lowmem(steps=1, use_inactive=inactive)
    out = dict(n_edges=len(g.ii), n_inac=len(g.ii_inac),
               poses=video.poses[:T], disps=video.disps[:T],
               damping=video.damping[:T], target=g.target, weight=g.weight,
               net=g.net.float())
    if upsample:
        out["disps_up"] = video.disps_up[:T]
    return {k: v.cpu().numpy() if torch.is_tensor(v) else v
            for k, v in out.items()}


@pytest.fixture(scope="module")
def serial(params):
    return {inac: _step(params, None, inac) for inac in (False, True)}


@pytest.mark.parametrize("n,inactive", [(2, False), (3, False), (4, False),
                                        (2, True)])
def test_mesh_lowmem_step_matches_serial(params, serial, n, inactive,
                                         monkeypatch):
    calls = []
    step = pback.lowmem_step_mesh
    monkeypatch.setattr(pback, "lowmem_step_mesh",
                        lambda *a, **k: calls.append(1) or step(*a, **k))
    chunks = []
    split = pback.shard_chunks
    monkeypatch.setattr(pback, "shard_chunks",
                        lambda m, c: chunks.append(len(c)) or split(m, c))
    got, want = _step(params, Mesh(["cpu"] * n), inactive), serial[inactive]
    assert calls == [1] and chunks == [4]
    assert got["n_edges"] == want["n_edges"] > 100
    assert got["n_inac"] == want["n_inac"] == (53 if inactive else 0)
    for k, (rtol, atol) in TOL.items():
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _jax_step(n):
    """JAX's update_lowmem step, serial or on n virtual devices; the state
    it leaves and the edges, on the host."""
    sys.path.insert(0, os.path.dirname(__file__))
    import test_torch_backend_scale as scale_test
    from droid_slam_tpu.models import weights as jweights
    from droid_slam_tpu.parallel import backend as jback
    from droid_slam_tpu.parallel.frontend import edge_parallel_mesh
    from droid_slam_tpu.state.graph import FactorGraph as JGraph

    video = scale_test._jax_video(T, SIZE)
    g = JGraph(video, jweights.load(CKPT), corr_impl="alt",
               max_factors=16 * T,
               mesh=None if n is None else edge_parallel_mesh(n))
    g.add_proximity_factors(rad=2, nms=3, thresh=22.0, beta=0.3)
    calls = []
    step = jback.lowmem_step_mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jback, "lowmem_step_mesh",
                   lambda *a, **k: calls.append(1) or step(*a, **k))
        g.update_lowmem(steps=1)
    assert len(calls) == (0 if n is None else 1)
    return dict(edges=sorted(zip(np.asarray(g.ii).tolist(),
                                 np.asarray(g.jj).tolist())),
                poses=np.asarray(video.buf.poses[:T]),
                disps=np.asarray(video.buf.disps[:T]))


def _edges(params, mesh):
    """The port's step with its edge list (sorted pairs)."""
    got = {}
    orig = FactorGraph.update_lowmem

    def spy(self, *a, **k):
        got["edges"] = sorted(zip(self.ii.tolist(), self.jj.tolist()))
        return orig(self, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FactorGraph, "update_lowmem", spy)
        got.update(_step(params, mesh))
    return got


def _jax_gaps(port, jax_):
    return (np.abs(port["poses"] - jax_["poses"]).max(),
            np.median(np.abs(port["disps"] - jax_["disps"])
                      / np.abs(jax_["disps"])),
            np.abs(port["disps"] - jax_["disps"]).max())


@pytest.fixture(scope="module")
def serial_against_jax(params):
    return _edges(params, None), _jax_step(None)


@pytest.mark.parametrize("n", [2, 3])
def test_mesh_lowmem_step_matches_jax_mesh_step(params, serial_against_jax,
                                                n):
    port, jax_ = _edges(params, Mesh(["cpu"] * n)), _jax_step(n)
    port1, jax1 = serial_against_jax
    assert port["edges"] == jax_["edges"] == port1["edges"]
    pose, disp_med, disp_max = _jax_gaps(port, jax_)
    pose1, disp_med1, disp_max1 = _jax_gaps(port1, jax1)
    moved = np.abs(jax_["poses"] - _video().poses[:T].numpy()).max()
    print(f"mesh {n} against JAX's: pose {pose:.3g} (moved {moved:.3g}), "
          f"disparity median rel {disp_med:.3g}, largest {disp_max:.3g}; "
          f"serial: {pose1:.3g}, {disp_med1:.3g}, {disp_max1:.3g}")
    assert moved > 1e-3
    assert pose <= 0.1 * moved + 1e-4 and disp_med <= 0.02
    assert pose <= pose1 + 2e-4 and disp_max <= disp_max1 + 2e-3


@pytest.mark.cuda
def test_mesh_lowmem_step_across_two_cards(monkeypatch):
    """The step with the chunks on cuda:0 and cuda:1 against the serial
    step on cuda:0, at the CPU case's tolerances, both with PyTorch's
    deterministic kernels. Without them one damping entry of 3072 parted
    by 1.7e-6 (3.14e-6 against 2.95e-6: e^x one bf16 ulp apart near
    x = -12.7, where an ulp is 1/16), beyond JAX's atol of 1e-6."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    from droid_slam_tpu_torch.models import weights as tweights
    if not os.path.exists(CKPT):
        pytest.skip(f"needs the trained checkpoint {CKPT}")
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    p = tweights.load(CKPT, "cuda:0")
    torch.use_deterministic_algorithms(True)
    try:
        want = _step(p, None, device="cuda:0")
        got = _step(p, Mesh(["cuda:0", "cuda:1"]), device="cuda:0")
    finally:
        torch.use_deterministic_algorithms(False)
    assert got["n_edges"] == want["n_edges"] > 100
    for k, (rtol, atol) in TOL.items():
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def test_shard_chunks_splits_uneven_runs():
    chunks = [(8 * k, np.arange(k, k + 1)) for k in range(5)]
    runs = pback.shard_chunks(Mesh(["cpu"] * 3), chunks)
    assert [[g for g, _ in r] for r in runs] == [[0, 8], [16, 24], [32]]
    runs = pback.shard_chunks(Mesh(["cpu"] * 7), chunks)
    assert [len(r) for r in runs] == [1, 1, 1, 1, 1, 0, 0]


def test_mesh_lowmem_with_upsample_takes_the_serial_sweep(params,
                                                          monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the chunk-parallel step ran with upsample")

    want = _step(params, None, upsample=True)
    monkeypatch.setattr(pback, "lowmem_step_mesh", refuse)
    got = _step(params, Mesh(["cpu"] * 2), upsample=True)
    assert np.abs(got["disps_up"]).max() > 0
    for k in ("poses", "disps", "damping", "target", "weight", "net",
              "disps_up"):
        assert np.array_equal(got[k], want[k]), k


def test_async_backend_goes_to_a_second_card(monkeypatch):
    """JAX puts video2 and the backend on devs[1] when there is one
    (droid_slam_tpu/slam/async_droid.py:47-52)."""
    pick = async_droid.backend_device
    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pick(cuda0) == cuda1
    assert pick("cuda") == cuda1
    assert pick(cuda1) == cuda0
    assert pick("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pick(cuda0) == cuda0
    assert pick(cuda0, count=4) == cuda1
    assert pick("cpu", count=4) == torch.device("cpu")
