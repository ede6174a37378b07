"""The port's correlation ops against the JAX package, and the CUDA lookup
kernel against its plain twin.

Tolerances are those of tests/test_corr_pallas.py: 1e-4 for f32 volumes
(the bilinear blend of the same taps, summed in another order) and 2e-2 for
bf16 volumes (one bf16 ulp of correlation values of order 1, blended).

The CUDA tests also run the kernel on a stereo frontend's plan, with the
(i, i) edges that correlate a keyframe's left view with its right one.

JAX is imported inside the tests that compare with it, so that the CUDA
test runs on a machine without JAX:
    python -m pytest --noconftest -m cuda \
        tests/test_torch_corr.py tests/test_torch_slice.py
"""

import numpy as np
import pytest
import torch

from droid_slam_tpu_torch.ops import corr as tcorr
from droid_slam_tpu_torch.ops import corr_cuda


def _jax():
    import jax.numpy as jnp
    from droid_slam_tpu.ops import corr as jcorr
    from droid_slam_tpu.ops import corr_pallas
    return jnp, jcorr, corr_pallas


ATOL = {np.float32: 1e-4, "bf16": 2e-2}


def _inputs(seed, EB=6, EA=4, h=8, w=12):
    rng = np.random.default_rng(seed)
    HW = h * w
    vol = rng.normal(size=(EB, HW, h, w)).astype(np.float32)
    slots = rng.permutation(EB)[:EA].astype(np.int32)
    # coordinates reach 2 px past every border: out-of-range taps are zero
    coords = (rng.uniform(size=(EA, HW, 2)) * np.array([w + 4, h + 4])
              - 2).astype(np.float32)
    return vol, slots, coords


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_lookup_level_plain_matches_pallas_and_xla(dtype):
    jnp, jcorr, corr_pallas = _jax()
    vol, slots, coords = _inputs(1)
    if dtype == "bf16":
        jvol = jnp.asarray(vol, jnp.bfloat16)
        tvol = torch.as_tensor(vol).to(torch.bfloat16)
    else:
        jvol, tvol = jnp.asarray(vol), torch.as_tensor(vol)
    got = tcorr.lookup_level_plain(tvol, torch.as_tensor(slots),
                                   torch.as_tensor(coords), 3).numpy()
    pallas = np.asarray(corr_pallas.lookup_level_slots(
        jvol, jnp.asarray(slots), jnp.asarray(coords), radius=3,
        interpret=True))
    xla = np.asarray(jcorr._lookup_level(
        jvol[jnp.asarray(slots)].astype(jnp.float32), jnp.asarray(coords), 3))
    assert got.shape == (4, 96, 49) and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, atol=ATOL[dtype])
    np.testing.assert_allclose(got, xla, atol=ATOL[dtype])


def test_lookup_plain_zero_outside_and_nan_propagates():
    jnp, jcorr, corr_pallas = _jax()
    vol, slots, coords = _inputs(2)
    coords[0, :10] = 1e7          # far outside: every tap zero
    coords[1, 0, 0] = np.nan      # NaN coordinate: NaN taps, as in JAX
    got = tcorr.lookup_level_plain(torch.as_tensor(vol),
                                   torch.as_tensor(slots),
                                   torch.as_tensor(coords), 3).numpy()
    want = np.asarray(jcorr._lookup_level(
        jnp.asarray(vol[slots]), jnp.asarray(coords), 3))
    assert (got[0, :10] == 0).all()
    assert np.isnan(got[1, 0]).all() and np.isnan(want[1, 0]).all()
    np.testing.assert_allclose(got[~np.isnan(want)], want[~np.isnan(want)],
                               atol=1e-4)


def test_lookup_plain_reads_zeros_for_slots_out_of_range():
    """A slot outside [0, EB) reads zeros, as the kernel's does; the other
    edges are unchanged."""
    vol, slots, coords = _inputs(7)
    bad = slots.copy()
    bad[1], bad[2] = len(vol) + 3, -1
    look = lambda sl: tcorr.lookup_level_plain(
        torch.as_tensor(vol), torch.as_tensor(sl), torch.as_tensor(coords),
        3).numpy()
    got, want = look(bad), look(slots)
    assert (got[1:3] == 0).all() and np.abs(want[1:3]).max() > 0
    np.testing.assert_array_equal(got[[0, 3]], want[[0, 3]])


@pytest.mark.parametrize("bf16", [False, True])
def test_build_pyramid_matches_jax(bf16):
    jnp, jcorr, corr_pallas = _jax()
    rng = np.random.default_rng(3)
    E, h, w = 3, 8, 12
    f1 = rng.normal(size=(E, h, w, 128)).astype(np.float32)
    f2 = rng.normal(size=(E, h, w, 128)).astype(np.float32)
    jd = jnp.bfloat16 if bf16 else jnp.float32
    td = torch.bfloat16 if bf16 else torch.float32
    want = jcorr.build_pyramid(jnp.asarray(f1, jd), jnp.asarray(f2, jd))
    nchw = lambda a: torch.as_tensor(a).permute(0, 3, 1, 2).to(td)
    got = tcorr.build_pyramid(nchw(f1), nchw(f2))
    assert len(got) == 4
    for g, w_ in zip(got, want):
        assert g.dtype == td and tuple(g.shape) == w_.shape
        w_ = np.asarray(w_.astype(jnp.float32))
        # f32: 128-term dot products in another order; bf16: one ulp of
        # values up to ~8, then pooled in bf16
        np.testing.assert_allclose(g.float().numpy(), w_,
                                   atol=6e-2 if bf16 else 1e-4)


def test_wrapper_routes_cpu_tensors_to_the_plain_twin():
    jnp, jcorr, corr_pallas = _jax()
    vol, slots, coords = _inputs(4)
    pyr = [torch.as_tensor(vol)]
    for _ in range(3):
        pyr.append(tcorr.avg_pool2(pyr[-1]))
    before = corr_cuda.LAUNCHES
    got = corr_cuda.lookup_pyramid_slots(pyr, torch.as_tensor(slots),
                                         torch.as_tensor(coords))
    assert corr_cuda.LAUNCHES == before          # no kernel on the CPU
    want = np.asarray(corr_pallas.lookup_pyramid_slots(
        [jnp.asarray(p.numpy()) for p in pyr], jnp.asarray(slots),
        jnp.asarray(coords), interpret=True))
    assert got.shape == (4, 96, 196)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    vol, slots, coords = _inputs(5)
    pyr = [torch.as_tensor(vol)]
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        corr_cuda._launch([p.to(meta) for p in pyr],
                          torch.as_tensor(slots).to(meta),
                          torch.as_tensor(coords).to(meta), 3)


# (h, w, EB, EA) of the kernel cases: the frontend's 40x64 plane (every
# level read as aligned 16-byte chunks in bf16); a 10x16 plane, HW = 160 not
# a multiple of the kernel's 64-pixel tile, whose 4- and 2-wide levels are
# read element by element; an odd 9x13 plane (every level element by
# element); one edge
CUDA_CASES = {"plane_40x64": (40, 64, 8, 6), "hw_160": (10, 16, 8, 6),
              "odd_9x13": (9, 13, 8, 6), "one_edge": (40, 64, 3, 1),
              "nan_and_bad_slots": (40, 64, 8, 6)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
@pytest.mark.parametrize("levels", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_twin(dtype, levels, case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    h, w, EB, EA = CUDA_CASES[case]
    vol, slots, coords = _inputs(6, EB=EB, EA=EA, h=h, w=w)
    if case == "nan_and_bad_slots":
        coords[0, :5] = np.nan       # NaN taps at every level
        coords[1, 5:9] = 1e7         # far outside: zero taps
        slots[2], slots[3] = EB + 3, -1   # slots outside [0, EB): zeros
    dev = torch.device("cuda")
    pyr = [torch.as_tensor(vol).to(dev, dtype)]
    for _ in range(levels - 1):
        pyr.append(tcorr.avg_pool2(pyr[-1]))
    s, c = torch.as_tensor(slots).to(dev), torch.as_tensor(coords).to(dev)
    before = corr_cuda.LAUNCHES
    got = corr_cuda.lookup_pyramid_slots(pyr, s, c)
    torch.cuda.synchronize()
    assert corr_cuda.LAUNCHES == before + 1
    assert got.shape == (EA, h * w, levels * 49)
    want = tcorr.lookup_pyramid_plain(pyr, s, c)
    atol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got, want, atol=atol, rtol=0, equal_nan=True)
    if case == "nan_and_bad_slots":
        assert got[0, :5].isnan().all()
        assert (got[1, 5:9] == 0).all()
        assert (got[2:4] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_twin_on_a_stereo_plan(dtype):
    """A stereo frontend's plan at 320x512: each keyframe's (i, i) edge
    correlates its left view with its right one, beside the (i, j) edges;
    the lookup's contract (identity slots, [E,HW,196]) is unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    from droid_slam_tpu_torch.lie import se3
    from droid_slam_tpu_torch.state.graph import FactorGraph
    from droid_slam_tpu_torch.state.video import DepthVideo

    dev = torch.device("cuda")
    n, h, w = 6, 40, 64
    gen = torch.Generator(device=dev).manual_seed(8)
    video = DepthVideo((8 * h, 8 * w), 8, dev, stereo=True)
    for k in range(n):
        video.append(float(k), pose=se3.exp(0.05 * torch.randn(
            6, generator=gen, device=dev)),
            disp=0.5 + torch.rand((h, w), generator=gen, device=dev),
            intrinsics=[40.0, 40.0, w / 2, h / 2],
            fmap=torch.randn((2, 128, h, w), generator=gen,
                             device=dev).to(torch.bfloat16))
    graph = FactorGraph(video, None)
    ii = [0, 1, 1, 2, 3, 3, 4, 5, 5]
    jj = [1, 0, 1, 2, 2, 3, 5, 4, 5]
    graph.add_factors(ii, jj)
    stereo = torch.as_tensor(graph.ii == graph.jj)
    assert int(stereo.sum()) == 4
    coords, _ = video.reproject(graph.ii, graph.jj)
    E = len(graph.ii)
    coords = coords.reshape(E, h * w, 2).contiguous()
    pyr = [p.to(dtype) for p in graph.pyramid]
    slots = torch.arange(E, dtype=torch.int32, device=dev)
    before = corr_cuda.LAUNCHES
    got = corr_cuda.lookup_pyramid_slots(pyr, slots, coords)
    torch.cuda.synchronize()
    assert corr_cuda.LAUNCHES == before + 1
    want = tcorr.lookup_pyramid_plain(pyr, slots, coords)
    atol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got, want, atol=atol, rtol=0)
    # the stereo edges' windows read the left-right volumes
    assert got[stereo.to(dev)].abs().max() > 1.0
