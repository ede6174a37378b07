"""The CUDA frame-distance kernel (``ops/frame_distance_cuda.py``,
``csrc/frame_distance.cu``) against its plain twin,
``geom/distance.py::frame_distance``.

On the CPU: the wrapper hands CPU tensors to the twin, refuses what the
kernel does not take, and ``DepthVideo.distance`` still runs the twin in
chunks of ``_DIST_CHUNK`` pairs. On a card (``-m cuda``, skipped without
CUDA): the kernel against the twin on the global BA's proposals (every pair
of 512 keyframes at the tum preset's 30x40, 64 at euroc's 40x64 and at
384x512's 48x64), one direction alone, the 1000 branch of a pose far
behind the camera, and ``DepthVideo.distance`` as one launch.

Tolerance of the kernel against the twin. Per pixel both evaluate the same
f32 formulas; the kernel rounds each of the twin's operations once, in the
twin's order, but the twin's own PyTorch kernels may fuse a product into an
add (its cross products), so a pixel's flow may part in its last bits: by
a few units in the last place of the coordinates it is made from, tens to
hundreds of pixels, ~1e-5 px. The mean of such flows parts by as much:
ATOL = 1e-4 px holds it ten times over, and RTOL_PIXEL = 1e-5 the flows'
relative rounding. The sums of n = h*w nonnegative flows, in two orders,
part by at most 2 gamma_n times the sum (gamma_n = n u / (1 - n u),
u = 2^-24), so by 2 gamma_n d in the distance. The valid counts are
integers in both, exact. So a pair parts by at most
(2 gamma_n + RTOL_PIXEL) d + ATOL, unless a pixel's depth lies within the
rounding of its terms of MIN_DEPTH_BA: there the two may count it on
either side of the cut, and move the mean by that pixel's flow over n. A
pair beyond the bound must show such a pixel in the twin's own geometry,
and only a few pairs may.

The card's tests import neither JAX nor the JAX package:
    python -m pytest --noconftest -m cuda tests/test_torch_frame_distance.py
"""

import numpy as np
import pytest
import torch

from droid_slam_tpu_torch.data.synthetic import (poses_c2w_from_mats,
                                                 random_trajectory)
from droid_slam_tpu_torch.geom import distance as gdist
from droid_slam_tpu_torch.geom import projective as gproj
from droid_slam_tpu_torch.lie import se3
from droid_slam_tpu_torch.ops import frame_distance_cuda
from droid_slam_tpu_torch.state.video import DepthVideo

U = 2.0 ** -24
ATOL, RTOL_PIXEL = 1e-4, 1e-5
# a pair beyond the bound needs a pixel whose depth lies within Z_ULPS
# units in the last place of its terms (|X0| + d |t|) of MIN_DEPTH_BA
Z_ULPS = 64
# at most this share of the pairs may be beyond the bound
SHARE_NEAR_CUT = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scene(t, h, w, seed=0, device="cpu"):
    """The global-BA tool's keyframes (tools/bench_global_ba_torch.py): a
    smooth random walk of t world-to-camera poses (step 0.04, rotation
    step 0.01), disparities U(0.8, 1.2) at h x w, intrinsics
    [0.8w, 0.8w, w/2, h/2]."""
    rng = np.random.default_rng(seed)
    Rs, ts = random_trajectory(t, rng, step=0.04, rot_step=0.01)
    poses = se3.inv(torch.as_tensor(poses_c2w_from_mats(Rs, ts)))
    disps = torch.as_tensor(rng.uniform(0.8, 1.2, size=(t, h, w))
                            .astype(np.float32))
    intr = torch.tensor([0.8 * w, 0.8 * w, w / 2, h / 2])
    return poses.to(device), disps.to(device), intr.to(device)


def _all_pairs(t, device="cpu", rows=torch.int64):
    ii, jj = torch.meshgrid(torch.arange(t), torch.arange(t), indexing="ij")
    return (ii.reshape(-1).to(device, rows).contiguous(),
            jj.reshape(-1).to(device, rows).contiguous())


# ---------------------------------------------------------------------------
# the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("rows", [torch.int32, torch.int64])
def test_wrapper_hands_cpu_tensors_to_the_twin(rows, bidirectional):
    poses, disps, intr = _scene(12, 6, 8, seed=1)
    poses[4, 2] = -50.0            # a pose far behind the camera
    ii, jj = _all_pairs(12, rows=rows)
    before = frame_distance_cuda.LAUNCHES
    got = frame_distance_cuda.frame_distance(poses, disps, intr, ii, jj, 0.3,
                                             bidirectional=bidirectional)
    assert frame_distance_cuda.LAUNCHES == before   # no kernel on the CPU
    want = gdist.frame_distance(poses, disps, intr, ii, jj, 0.3,
                                bidirectional=bidirectional)
    assert got.shape == (144,) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert (want >= 500).any() and (want < 100).any()


def _meta_case(defect):
    """The operands of a valid call on ``meta`` with one defect."""
    poses, disps, intr = _scene(5, 4, 6)
    ii, jj = _all_pairs(5)
    if defect == "f64_poses":
        poses = poses.double()
    elif defect == "pose_width":
        poses = poses[:, :6].contiguous()
    elif defect == "strided_poses":
        poses = poses.t().contiguous().t()
    elif defect == "f64_disps":
        disps = disps.double()
    elif defect == "flat_disps":
        disps = disps.reshape(5, -1)
    elif defect == "strided_disps":
        disps = disps.transpose(1, 2)
    elif defect == "disps_rows":
        disps = disps[:4]
    elif defect == "intrinsics_rows":
        intr = intr.expand(5, 4)
    elif defect == "intrinsics_width":
        intr = intr[:3]
    elif defect == "f64_intrinsics":
        intr = intr.double()
    elif defect == "rows_dtype":
        ii = ii.float()
    elif defect == "rows_mixed":
        jj = jj.int()
    elif defect == "rows_shape":
        ii = ii[:3]
    elif defect == "rows_rank":
        ii, jj = ii.reshape(5, 5), jj.reshape(5, 5)
    meta = torch.device("meta")
    return tuple(x.to(meta) for x in (poses, disps, intr, ii, jj))


REFUSALS = {"f64_poses": "poses must be", "pose_width": "poses must be",
            "strided_poses": "poses must be", "f64_disps": "disps must be",
            "flat_disps": "disps must be", "strided_disps": "disps must be",
            "disps_rows": "disps must be",
            "intrinsics_rows": "intrinsics must be one",
            "intrinsics_width": "intrinsics must be one",
            "f64_intrinsics": "intrinsics must be one",
            "rows_dtype": "ii and jj", "rows_mixed": "ii and jj",
            "rows_shape": "ii and jj", "rows_rank": "ii and jj",
            "valid": "unsupported device meta"}


@pytest.mark.parametrize("defect", sorted(REFUSALS))
def test_wrapper_refuses_what_the_kernel_does_not_take(defect):
    """Each check in turn, on ``meta`` tensors: a call with no defect
    passes them all and stops at the device, which is not a card."""
    with pytest.raises(ValueError, match=REFUSALS[defect]):
        frame_distance_cuda._launch(*_meta_case(defect), 0.3, True)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_video_distance_on_the_cpu_is_the_chunked_twin(bidirectional,
                                                       monkeypatch):
    """``DepthVideo.distance`` on the CPU: the twin ``_DIST_CHUNK`` pairs
    at a time (here 64, so 200 pairs cross three chunk boundaries), equal
    bit for bit to the twin over every pair at once."""
    t, h, w = 20, 6, 8
    poses, disps, intr = _scene(t, h, w, seed=2)
    video = DepthVideo(image_size=(8 * h, 8 * w), buffer=t + 4, device="cpu")
    video.poses[:t], video.disps[:t] = poses, disps
    video.intrinsics[:] = intr
    video.counter = t
    rng = np.random.default_rng(3)
    ii, jj = rng.integers(0, t, 200), rng.integers(0, t, 200)
    calls = []
    plain = gdist.frame_distance

    def counted(p, d, k, i, j, *a, **kw):
        calls.append(len(i))
        return plain(p, d, k, i, j, *a, **kw)

    monkeypatch.setattr(gdist, "frame_distance", counted)
    monkeypatch.setattr(DepthVideo, "_DIST_CHUNK", 64)
    before = frame_distance_cuda.LAUNCHES
    got = video.distance(ii, jj, beta=0.3, bidirectional=bidirectional)
    assert calls == [64, 64, 64, 8]
    assert frame_distance_cuda.LAUNCHES == before
    want = plain(video.poses, video.disps, video.intrinsics[0],
                 torch.as_tensor(ii), torch.as_tensor(jj), 0.3,
                 bidirectional=bidirectional)
    assert got.shape == (200,) and torch.equal(got, want)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

# the global BA's feature maps and keyframes: the tum preset (240x320, its
# buffer of 512, whose walk takes far pairs out of each other's view: the
# 1000 branch), euroc (320x512), 384x512 (chip_smoke's and the tool's
# largest)
SHAPES = {"tum_30x40": (512, 30, 40), "euroc_40x64": (64, 40, 64),
          "big_48x64": (64, 48, 64)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def _twin(poses, disps, intr, ii, jj, bidirectional, chunk=32768):
    """The twin on the card, in the chunks ``DepthVideo.distance`` ran
    it in."""
    return torch.cat([
        gdist.frame_distance(poses, disps, intr, ii[s:s + chunk],
                             jj[s:s + chunk], 0.3,
                             bidirectional=bidirectional)
        for s in range(0, len(ii), chunk)])


def _near_the_cut(poses, disps, intr, ii, jj, bidirectional):
    """Per pair: whether a pixel of either warp, in either direction the
    distance reads, has its depth within Z_ULPS units in the last place of
    its terms of MIN_DEPTH_BA (the twin's formulas)."""
    near = torch.zeros(len(ii), dtype=torch.bool, device=ii.device)
    for a, b in ((ii, jj), (jj, ii))[:2 if bidirectional else 1]:
        d = disps[a]
        X0 = gproj.iproj(d, intr.expand(len(a), 4))
        G = se3.relative(poses[a], poses[b])
        z_full = se3.act(G[:, None, None, :], X0)[..., 2]
        z_trans = X0[..., 2] + d * G[:, None, None, 2]
        eps = Z_ULPS * U * (X0[..., :3].norm(dim=-1)
                            + d * G[:, None, None, :3].norm(dim=-1))
        for z in (z_full, z_trans):
            near |= ((z - gproj.MIN_DEPTH_BA).abs() <= eps).flatten(1).any(1)
    return near


def _hold(got, want, poses, disps, intr, ii, jj, bidirectional):
    """The bound of the module's docstring; returns the number of pairs
    beyond it (each with a pixel at the depth cut) and the largest gap
    within it."""
    n = disps.shape[1] * disps.shape[2]
    gamma = n * U / (1 - n * U)
    tol = (2 * gamma + RTOL_PIXEL) * want.abs() + ATOL
    gap = (got - want).abs()
    beyond = torch.nonzero(~(gap <= tol))[:, 0]
    if len(beyond):
        near = _near_the_cut(poses, disps, intr, ii[beyond], jj[beyond],
                             bidirectional)
        assert near.all(), (
            f"pairs beyond the bound with no pixel at the depth cut: "
            f"{beyond[~near][:8].tolist()}, gaps "
            f"{gap[beyond[~near]][:8].tolist()}")
        assert len(beyond) <= SHARE_NEAR_CUT * len(ii)
    inside = gap[gap <= tol]
    return len(beyond), float(inside.max()) if len(inside) else 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [torch.int32, torch.int64])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cuda_kernel_matches_plain_twin(shape, rows):
    dev = _card()
    t, h, w = SHAPES[shape]
    poses, disps, intr = _scene(t, h, w, device=dev)
    ii, jj = _all_pairs(t, dev, rows)
    before = frame_distance_cuda.LAUNCHES
    got = frame_distance_cuda.frame_distance(poses, disps, intr, ii, jj, 0.3)
    torch.cuda.synchronize()
    assert frame_distance_cuda.LAUNCHES == before + 1
    assert got.shape == (t * t,) and got.dtype == torch.float32
    assert got.device == disps.device
    want = _twin(poses, disps, intr, ii, jj, True)
    beyond, err = _hold(got, want, poses, disps, intr, ii, jj, True)
    print(f"{shape} t={t} {rows}: max |kernel - twin| {err:.3g} within the "
          f"bound, {beyond} pairs at the depth cut")
    # the proposal's range: pairs under its threshold, and at t=512 the
    # 1000 branch
    assert (want < 22).sum() > 4 * t
    assert (want >= 500).any() == (t == 512)


@pytest.mark.cuda
def test_cuda_kernel_one_direction():
    dev = _card()
    poses, disps, intr = _scene(64, 30, 40, seed=4, device=dev)
    ii, jj = _all_pairs(64, dev)
    got = frame_distance_cuda.frame_distance(poses, disps, intr, ii, jj, 0.3,
                                             bidirectional=False)
    want = _twin(poses, disps, intr, ii, jj, False)
    _hold(got, want, poses, disps, intr, ii, jj, False)
    # one direction is not the pair's mean
    both = _twin(poses, disps, intr, ii, jj, True)
    assert float((want - both).abs().max()) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("bidirectional", [True, False])
def test_cuda_kernel_far_behind_the_camera(bidirectional):
    """A pose 50 units behind the others (as tests/test_torch_modules.py::
    test_frame_distance_matches_jax builds it): its pairs take the 1000
    branch, in the same directions as the twin's."""
    dev = _card()
    poses, disps, intr = _scene(24, 30, 40, seed=5, device=dev)
    poses[4, 2] = -50.0
    ii, jj = _all_pairs(24, dev)
    got = frame_distance_cuda.frame_distance(
        poses, disps, intr, ii, jj, 0.3, bidirectional=bidirectional)
    want = _twin(poses, disps, intr, ii, jj, bidirectional)
    assert (want >= 500).sum() >= 23
    assert torch.equal(got >= 500, want >= 500)
    _hold(got, want, poses, disps, intr, ii, jj, bidirectional)


@pytest.mark.cuda
def test_cuda_kernel_takes_no_pairs_and_rows_outside():
    """No pairs: no launch. A row outside the video reads NaN (the twin
    would raise); the other pairs are the twin's."""
    dev = _card()
    poses, disps, intr = _scene(8, 30, 40, seed=6, device=dev)
    ii, jj = _all_pairs(8, dev)
    before = frame_distance_cuda.LAUNCHES
    none = frame_distance_cuda.frame_distance(poses, disps, intr, ii[:0],
                                              jj[:0])
    assert none.shape == (0,) and frame_distance_cuda.LAUNCHES == before
    bad_ii, bad_jj = ii.clone(), jj.clone()
    bad_ii[1], bad_jj[2] = 8, -1
    got = frame_distance_cuda.frame_distance(poses, disps, intr, bad_ii,
                                             bad_jj)
    assert got[1:3].isnan().all()
    keep = torch.ones(64, dtype=torch.bool, device=dev)
    keep[1:3] = False
    want = _twin(poses, disps, intr, ii, jj, True)
    _hold(got[keep], want[keep], poses, disps, intr, ii[keep], jj[keep],
          True)


@pytest.mark.cuda
def test_cuda_video_distance_is_one_launch(monkeypatch):
    """``DepthVideo.distance`` on the card: one launch over every pair,
    however many chunks the CPU would take (4 at a chunk of 1024), with
    the twin's values."""
    dev = _card()
    monkeypatch.setattr(DepthVideo, "_DIST_CHUNK", 1024)
    t, h, w = 64, 30, 40
    poses, disps, intr = _scene(t, h, w, seed=7, device=dev)
    video = DepthVideo(image_size=(8 * h, 8 * w), buffer=t + 8, device=dev)
    video.poses[:t], video.disps[:t] = poses, disps
    video.intrinsics[:] = intr
    video.counter = t
    ii, jj = _all_pairs(t)
    before = frame_distance_cuda.LAUNCHES
    got = video.distance(ii.numpy(), jj.numpy(), beta=0.3)
    assert frame_distance_cuda.LAUNCHES == before + 1
    assert len(ii) == 4 * DepthVideo._DIST_CHUNK
    ii, jj = ii.to(dev), jj.to(dev)
    want = _twin(video.poses, video.disps, video.intrinsics[0], ii, jj, True,
                 chunk=1024)
    _hold(got, want, video.poses, video.disps, video.intrinsics[0], ii, jj,
          True)
