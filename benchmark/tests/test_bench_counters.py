"""The operation and byte counts that ``mfu.*`` and ``*_roofline`` divide
by: ``benchmark/flops.py`` against ``torch.utils.flop_counter`` over the
port's networks at a small size (the frontend's update, with the GRU's
context share precomputed, and the backend's, with the full context path),
and ``benchmark/bytes.py``'s lookup count against chip_smoke.py's count,
transcribed, at the shape its kernels phase uses."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import bytes as nbytes, flops
from droid_slam_tpu_torch.models import nets, weights
from droid_slam_tpu_torch.ops import corr as corr_ops


def _count(fn):
    with FlopCounterMode(display=False) as m:
        fn()
    return m.get_total_flops()


@pytest.fixture(scope="module")
def params():
    return weights.init_params(0)


def test_encoders(params):
    img = torch.zeros((1, 40, 56, 3), dtype=torch.uint8)
    got = _count(lambda: nets.extract_features(params, img))
    assert got == flops.encoders(40, 56)


@pytest.mark.parametrize("E,frames", [(5, 3), (9, 4)])
def test_frontend_update(params, E, frames):
    h, w = 6, 8
    g = torch.Generator().manual_seed(E)
    net, inp = (torch.randn(E, 128, h, w, generator=g) for _ in range(2))
    corr = torch.randn(E, flops.CORR, h, w, generator=g)
    motn = torch.randn(E, 4, h, w, generator=g)
    ii = torch.arange(E) % frames
    pre = nets.gru_context_pre(params, inp)
    got = _count(lambda: nets.update_module(params, net, None, corr, motn,
                                            ii=ii, num_frames=frames,
                                            pre=pre))
    assert got == flops.update(E, h, w, pre=True) + flops.agg(E, frames, h,
                                                              w)
    assert _count(lambda: nets.gru_context_pre(params, inp)) == \
        flops.context_pre(E, h, w)


def test_backend_update(params):
    E, frames, h, w = 7, 8, 5, 6
    g = torch.Generator().manual_seed(1)
    net, inp = (torch.randn(E, 128, h, w, generator=g) for _ in range(2))
    corr = torch.randn(E, flops.CORR, h, w, generator=g)
    motn = torch.randn(E, 4, h, w, generator=g)
    ii = torch.arange(E) % frames
    got = _count(lambda: nets.update_module(params, net, inp, corr, motn,
                                            ii=ii, num_frames=frames))
    assert got == flops.update(E, h, w) + flops.agg(E, frames, h, w)
    f = torch.randn(3, 128, h, w, generator=g)
    assert _count(lambda: corr_ops.build_volume(f, f)) == \
        flops.volumes(3, h, w)


def test_alt_correlation_count():
    E, h, w = 3, 8, 12
    g = torch.Generator().manual_seed(2)
    fmaps = torch.randn(4, 128, h, w, generator=g)
    pyr = corr_ops.build_fmap_pyramid(fmaps)
    coords = torch.rand(E, h * w, 2, generator=g) * torch.tensor([w, h])
    ii, jj = torch.tensor([0, 1, 2]), torch.tensor([1, 2, 3])
    assert _count(lambda: corr_ops.alt_lookup(pyr, coords, ii, jj)) == \
        flops.alt_corr(E, h, w)


def _chip_smoke_bytes(h, w):
    """chip_smoke.py's kernels phase, its byte count transcribed: EB=64
    volumes, EA=48 edges, coordinates U(-4, w+4) x U(-4, h+4) from
    default_rng(0) after the slot permutation, bf16 volumes."""
    EB, EA = 64, 48
    HW = h * w
    rng = np.random.default_rng(0)
    rng.permutation(EB)
    coords = torch.as_tensor(
        (rng.uniform(size=(EA, HW, 2)) * np.array([w + 8, h + 8]) - 4)
        .astype(np.float32))
    touched = 0
    for lvl in range(4):
        h2, w2 = h >> lvl, w >> lvl
        c = coords / 2.0 ** lvl
        lo = torch.floor(c) - 3
        nx = ((lo[..., 0] + 8).clamp(max=w2)
              - lo[..., 0].clamp(min=0)).clamp(0, 8)
        ny = ((lo[..., 1] + 8).clamp(max=h2)
              - lo[..., 1].clamp(min=0)).clamp(0, 8)
        touched += int((nx * ny).sum())
    out_numel = EA * HW * 4 * 49
    return (out_numel * 4 + coords.numel() * 4 + EA * 4 + touched * 2,
            coords.numpy())


@pytest.mark.parametrize("h,w", [(40, 64), (30, 40)])
def test_lookup_bytes_match_chip_smoke(h, w):
    want, coords = _chip_smoke_bytes(h, w)
    assert nbytes.lookup(48, h, w, elem=2, coords=coords) == want


def test_lookup_bytes_at_the_identity_warp():
    h, w = 40, 64
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack([x, y], -1).reshape(1, h * w, 2).astype(np.float32)
    assert nbytes.lookup(3, h, w) == 3 * nbytes.lookup(1, h, w)
    assert nbytes.lookup(1, h, w) == nbytes.lookup(1, h, w, coords=grid)
