"""The CUDA on-the-fly correlation kernel (``ops/alt_corr_cuda.py``,
``csrc/alt_corr.cu``) against its plain twin, ``ops/corr.py::alt_lookup``.

On the CPU: the wrapper hands CPU tensors to the twin, refuses what the
kernel does not take, and both global-BA sweeps (serial and over a mesh)
correlate through it. On a card (``-m cuda``, skipped without CUDA): the
kernel against the twin at the feature maps of the presets' global BA
(30x40 tum, 40x64 euroc, 48x64 at 384x512), and one ``update_lowmem`` step
with the kernel against the same step with the twin.

Tolerance of the kernel against the twin: both sum the same exact bf16 x
bf16 products (exact in f32) in f32, in another order, so each dot
product of n = 128 terms parts from the exact sum by at most
gamma_n * sum|a_i b_i| (gamma_n = n u / (1 - n u), u = 2^-24), and the two
from each other by twice that, at most 2 gamma_n |a| |b| (Cauchy-Schwarz),
over 16; the bilinear blend's convex weights carry that bound over, and add
the rounding of four products and three sums of taps, a few u of the
largest tap. TF32 stays off (PyTorch's default for f32 matmuls), so the
twin's gemv sums in full f32.

The card's tests import neither JAX nor the JAX package:
    python -m pytest --noconftest -m cuda tests/test_torch_alt_corr.py
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from droid_slam_tpu_torch.ops import alt_corr_cuda
from droid_slam_tpu_torch.ops import corr as tcorr

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "checkpoints", "r5_006000.npz")
U = 2.0 ** -24


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(seed, h, w, E, frames=12, stereo=False, rows=torch.int64,
            device="cpu"):
    """A feature pyramid of ``frames`` frames (two views each in stereo,
    rows n*2 + view), E edges and their level-0 coordinates: the identity
    grid moved by a few pixels, with exact integers, negative coordinates,
    points just past every border and far outside among them."""
    rng = np.random.default_rng(seed)
    views = 2 if stereo else 1
    fm = torch.as_tensor(rng.normal(size=(frames * views, 128, h, w))
                         .astype(np.float32)).to(torch.bfloat16)
    pyr = [p.to(device) for p in tcorr.build_fmap_pyramid(fm)]
    ii = rng.integers(0, frames, E)
    jj = np.where(rng.uniform(size=E) < 0.2, ii, rng.integers(0, frames, E))
    if stereo:   # the left view of ii, view (ii == jj) of jj
        ii, jj = ii * 2, jj * 2 + (ii == jj)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack([xs, ys], -1).reshape(1, h * w, 2).astype(np.float32)
    coords = grid + rng.normal(scale=3.0, size=(E, h * w, 2))
    coords[:, 0::7] = np.round(coords[:, 0::7])             # exact integers
    coords[:, 1::7] = -rng.uniform(0, 6, size=(E, len(range(1, h * w, 7)),
                                               2))           # negative
    coords[:, 2::7, 0] = w + rng.uniform(-1, 4, size=(E, len(range(
        2, h * w, 7))))                                      # past the edge
    coords[:, 3::7, 1] = h + rng.uniform(-1, 4, size=(E, len(range(
        3, h * w, 7))))
    coords[:, 4::97] = 1e5                                   # far outside
    as_rows = lambda a: torch.as_tensor(a).to(device, rows)
    return (pyr, torch.as_tensor(coords.astype(np.float32)).to(device),
            as_rows(ii), as_rows(jj))


def _atol(pyr, got):
    """The bound of the module's docstring for these inputs."""
    norm = max(float(p.float().norm(dim=-1).max()) for p in pyr)
    gamma = 128 * U / (1 - 128 * U)
    return 2 * gamma * norm * norm / 16 + 8 * U * float(got.abs().max())


# ---------------------------------------------------------------------------
# the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stereo", [False, True])
@pytest.mark.parametrize("rows", [torch.int32, torch.int64])
@pytest.mark.parametrize("hw", [(8, 12), (10, 14)])
def test_wrapper_hands_cpu_tensors_to_the_twin(hw, rows, stereo):
    pyr, coords, ii, jj = _inputs(1, *hw, E=5, frames=4, stereo=stereo,
                                  rows=rows)
    before = alt_corr_cuda.LAUNCHES
    got = alt_corr_cuda.alt_lookup(pyr, coords, ii, jj)
    assert alt_corr_cuda.LAUNCHES == before      # no kernel on the CPU
    want = tcorr.alt_lookup(pyr, coords, ii, jj)
    assert got.shape == (5, hw[0] * hw[1], 196) and got.dtype == torch.float32
    assert torch.equal(got, want)


def _meta_case(defect):
    """The operands of a valid call on ``meta`` with one defect."""
    pyr, coords, ii, jj = _inputs(2, 8, 12, E=3, frames=3)
    if defect == "f32_levels":
        pyr = [p.float() for p in pyr]
    elif defect == "channels":
        pyr = [p[..., :64].contiguous() for p in pyr]
    elif defect == "strided_level":
        pyr = [pyr[0].transpose(1, 2)] + pyr[1:]
    elif defect == "strided_coords":
        coords = coords.transpose(0, 1).contiguous().transpose(0, 1)
    elif defect == "f64_coords":
        coords = coords.double()
    elif defect == "pixels":
        coords = coords[:, :-1].contiguous()
    elif defect == "rows_dtype":
        ii = ii.float()
    elif defect == "rows_mixed":
        jj = jj.int()
    elif defect == "rows_shape":
        ii = ii[:2]
    elif defect == "five_levels":
        pyr = pyr + pyr[-1:]
    elif defect == "rows_count":
        pyr = [pyr[0][:2]] + pyr[1:]
    meta = torch.device("meta")
    return ([p.to(meta) for p in pyr], coords.to(meta), ii.to(meta),
            jj.to(meta))


REFUSALS = {"f32_levels": "levels must be", "channels": "levels must be",
            "strided_level": "levels must be", "rows_count": "levels must be",
            "strided_coords": "coords must be", "f64_coords": "coords must be",
            "pixels": "pixels must be level 0",
            "rows_dtype": "ii and jj", "rows_mixed": "ii and jj",
            "rows_shape": "ii and jj", "five_levels": "1..4 levels",
            "valid": "unsupported device meta"}


@pytest.mark.parametrize("defect", sorted(REFUSALS))
def test_wrapper_refuses_what_the_kernel_does_not_take(defect):
    """Each check in turn, on ``meta`` tensors: a call with no defect
    passes them all and stops at the device, which is not a card."""
    pyr, coords, ii, jj = _meta_case(defect)
    with pytest.raises(ValueError, match=REFUSALS[defect]):
        alt_corr_cuda._launch(pyr, coords, ii, jj, tcorr.RADIUS)
    with pytest.raises(ValueError, match="radius"):
        alt_corr_cuda._launch(pyr, coords, ii, jj, 4)


def _tool():
    spec = importlib.util.spec_from_file_location(
        "bench_global_ba_torch",
        os.path.join(ROOT, "tools", "bench_global_ba_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _params(device):
    from droid_slam_tpu_torch.models import weights as tweights
    if not os.path.exists(CKPT):
        pytest.skip(f"needs the trained checkpoint {CKPT}")
    return tweights.load(CKPT, device)


def _step(params, video, mesh=None):
    """One global-BA step (``update_lowmem``) over the backend's proposal."""
    from droid_slam_tpu_torch.slam.droid import f32_matmuls
    from droid_slam_tpu_torch.state.graph import FactorGraph
    t = video.counter
    g = FactorGraph(video, params, max_factors=16 * t, corr_impl="alt",
                    mesh=mesh)
    g.add_proximity_factors(rad=2, nms=3, thresh=22.0, beta=0.3)
    with torch.no_grad(), f32_matmuls():
        g.update_lowmem(steps=1)
    return g


@pytest.mark.parametrize("n_devices", [None, 2])
def test_global_ba_sweeps_correlate_through_the_wrapper(n_devices,
                                                        monkeypatch):
    """The serial sweep and the chunk-parallel one call the wrapper once a
    chunk (16 keyframes at 64x96; the mesh's chunks are frames [0, 8) and
    [8, 16), the serial sweep's cap is lowered to ~40 edges a chunk), with
    the feature pyramid and the chunk's own edges."""
    from droid_slam_tpu_torch.parallel.mesh import Mesh
    from droid_slam_tpu_torch.state import graph as graph_mod
    monkeypatch.setattr(graph_mod, "SWEEP_EDGE_PIXELS", 40 * 96)
    calls = []
    plain = alt_corr_cuda.alt_lookup

    def counted(pyr, coords, ii, jj, *a):
        calls.append((len(pyr), tuple(coords.shape), len(ii), len(jj)))
        return plain(pyr, coords, ii, jj, *a)

    monkeypatch.setattr(alt_corr_cuda, "alt_lookup", counted)
    video = _tool().synthetic_video(16, (64, 96), "cpu")
    mesh = None if n_devices is None else Mesh(["cpu"] * n_devices)
    g = _step(_params("cpu"), video, mesh)
    assert len(calls) == g.sweep_chunks >= 2
    if mesh is not None:
        assert len(calls) == 2
    assert sum(c[2] for c in calls) == len(g.ii) > 20
    assert all(c[0] == 4 and c[1][1:] == (96, 2) and c[1][0] == c[2] == c[3]
               for c in calls)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

# the global BA's feature maps: the tum preset (240x320), euroc (320x512),
# 384x512 (chip_smoke's and the tool's largest)
SHAPES = {"tum_30x40": (30, 40), "euroc_40x64": (40, 64),
          "big_48x64": (48, 64)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("stereo", [False, True])
@pytest.mark.parametrize("rows", [torch.int32, torch.int64])
@pytest.mark.parametrize("E", [0, 1, 127])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cuda_kernel_matches_plain_twin(shape, E, rows, stereo):
    dev = _card()
    h, w = SHAPES[shape]
    pyr, coords, ii, jj = _inputs(3, h, w, E, frames=24, stereo=stereo,
                                  rows=rows, device=dev)
    assert not torch.backends.cuda.matmul.allow_tf32
    before = alt_corr_cuda.LAUNCHES
    got = alt_corr_cuda.alt_lookup(pyr, coords, ii, jj)
    torch.cuda.synchronize()
    assert got.shape == (E, h * w, 196) and got.dtype == torch.float32
    assert got.device == coords.device
    if E == 0:     # nothing to launch (the twin cannot reshape no edges)
        assert alt_corr_cuda.LAUNCHES == before
        return
    assert alt_corr_cuda.LAUNCHES == before + 1
    want = tcorr.alt_lookup(pyr, coords, ii, jj)
    atol = _atol(pyr, want)
    err = float((got - want).abs().max())
    print(f"{shape} E={E} {rows} stereo={stereo}: max |kernel - twin| "
          f"{err:.3g}, bound {atol:.3g}")
    torch.testing.assert_close(got, want, atol=atol, rtol=0)
    # the cases the inputs hold: zero windows far outside, and taps
    far = coords[..., 0] >= 1e5
    assert far.any() and (got[far] == 0).all()
    assert float(want.abs().max()) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [1, 2, 3])
def test_cuda_kernel_matches_plain_twin_on_fewer_levels(levels):
    """A pyramid of fewer levels: the kernel reads its depth from its
    input, and writes levels * 49 channels."""
    dev = _card()
    pyr, coords, ii, jj = _inputs(5, 30, 40, 9, device=dev)
    pyr = pyr[:levels]
    got = alt_corr_cuda.alt_lookup(pyr, coords, ii, jj)
    want = tcorr.alt_lookup(pyr, coords, ii, jj)
    assert got.shape == want.shape == (9, 1200, 49 * levels)
    torch.testing.assert_close(got, want, atol=_atol(pyr, want), rtol=0)


@pytest.mark.cuda
def test_cuda_kernel_propagates_nan_and_zeroes_rows_outside():
    """A NaN coordinate gives NaN taps, as in the twin; a row outside the
    pyramid reads zeros (the twin would raise); the other edges are the
    twin's."""
    dev = _card()
    pyr, coords, ii, jj = _inputs(4, 30, 40, 6, frames=6, device=dev)
    coords[0, :3] = float("nan")
    bad_ii, bad_jj = ii.clone(), jj.clone()
    bad_ii[1], bad_jj[2] = 6, -1
    got = alt_corr_cuda.alt_lookup(pyr, coords, bad_ii, bad_jj)
    want = tcorr.alt_lookup(pyr, coords, ii, jj)
    assert got[0, :3].isnan().all() and want[0, :3].isnan().all()
    assert (got[1:3] == 0).all()
    keep = [0, 3, 4, 5]
    torch.testing.assert_close(got[keep], want[keep],
                               atol=_atol(pyr, want[3:]), rtol=0,
                               equal_nan=True)


# one update_lowmem step at t=64 (240x320, the tum preset's feature maps)
# with the kernel against the same step with the twin. The correlation
# parts in its last bits (above), but the update operator reads it in bf16,
# so a few features round to the neighbouring bf16 value and the step's BA
# carries that on. The witness is the twin's step with its correlation
# scaled by 1 + 2^-22, a last-bit change: on the card (NVIDIA H100 80GB
# HBM3) it moved the disparities by up to 0.0070 (mean 5.2e-5) and the
# poses by 8.6e-6, the kernel by 0.0074 (2.4e-5) and 8.0e-6, two runs of
# the twin by 2.4e-5 (4.8e-6) and 3.1e-6. The step's sweep runs in chunks
# of at most SWEEP_EDGES edges (the cap lowered from its default, which
# holds every edge at t=64 in one chunk), so that the kernel's launches
# start past frame 0 and read offset views of the packed plan. The
# kernel's disparity gaps are held to WITNESS_X times the witness's of
# the same run; its poses to JAX's
# bound for another summation order of the same step (the mesh sweep
# against the serial one, tests/test_lowmem_spill.py:121-131)
WITNESS_SCALE, WITNESS_X, POSE_ATOL = 1 + 2.0 ** -22, 3.0, 2e-4
SWEEP_EDGES = 128


@pytest.mark.cuda
def test_cuda_update_lowmem_step_matches_the_twins(monkeypatch):
    from droid_slam_tpu_torch.state import graph as graph_mod
    dev = _card()
    params = _params(dev)
    tool = _tool()
    monkeypatch.setattr(graph_mod, "SWEEP_EDGE_PIXELS", SWEEP_EDGES * 1200)
    witness = lambda *a: tcorr.alt_lookup(*a) * WITNESS_SCALE
    out, launches, chunks = {}, {}, {}
    for name, fn in (("twin", tcorr.alt_lookup), ("kernel", None),
                     ("witness", witness)):
        with monkeypatch.context() as mp:
            if fn is not None:
                mp.setattr(alt_corr_cuda, "alt_lookup", fn)
            video = tool.synthetic_video(64, (240, 320), dev)
            start = video.poses[:64].cpu()
            before = alt_corr_cuda.LAUNCHES
            g = _step(params, video)
            torch.cuda.synchronize()
            launches[name] = alt_corr_cuda.LAUNCHES - before
            chunks[name] = (g.sweep_chunks,
                            [(ch.g0, len(ch.sel)) for ch in g._sweep_plan(1)])
            out[name] = dict(edges=(g.ii.copy(), g.jj.copy()),
                             poses=video.poses[:64].cpu(),
                             disps=video.disps[:64].cpu(), start=start)
    # one launch a chunk of the plan, several chunks, each within the cap
    ran, plan = chunks["kernel"]
    assert launches == {"twin": 0, "kernel": len(plan), "witness": 0}
    assert ran == len(plan) >= 4 and chunks["twin"] == chunks["kernel"]
    assert plan[0][0] == 0 < plan[-1][0]
    assert all(n <= SWEEP_EDGES for _, n in plan)
    a = out["twin"]
    assert all(np.array_equal(x, y) for x, y in zip(a["edges"],
                                                    out["kernel"]["edges"]))
    gaps = {}
    for name in ("kernel", "witness"):
        d = (out[name]["disps"] - a["disps"]).abs()
        gaps[name] = dict(
            pose=float((out[name]["poses"] - a["poses"]).abs().max()),
            disp_max=float(d.max()), disp_mean=float(d.mean()))
    moved = float((a["poses"] - a["start"]).abs().max())
    print(f"update_lowmem t=64: the step moved poses by {moved:.3g}; gaps "
          f"to the twin {gaps}")
    assert moved > 10 * POSE_ATOL
    k, w = gaps["kernel"], gaps["witness"]
    assert k["pose"] <= POSE_ATOL
    assert 0 < w["disp_mean"] and k["disp_mean"] <= WITNESS_X * w["disp_mean"]
    assert k["disp_max"] <= WITNESS_X * w["disp_max"]
