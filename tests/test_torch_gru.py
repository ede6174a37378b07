"""The port's ConvGRU gate epilogues against the JAX package, and the CUDA
kernels against their plain twins.

The twins (ops/gru.py) are held against the Pallas kernels of
droid_slam_tpu/ops/gru_pallas.py in interpret mode on the same numpy
inputs, transposed NHWC <-> NCHW: both compute in f32 and round once, so
they agree to f32 rounding (tolerance 1e-5; read: 2.4e-7) in f32 and to one
bf16 ulp of the outputs (|values| <= 1, tolerance 1e-2; read: 3.9e-3) in
bf16. The port's conv_gru(fused_epilogue=True) is held against the JAX
conv_gru(pallas_ok=True), whose epilogues run in interpret mode (its
import-time flag monkeypatched, as tests/test_gru_pallas.py does): read on
seeds 2-4, 1.5e-6 in f32 and 7.8e-3 (one ulp) in bf16; the port's default
branch, which rounds its intermediate sums to bf16, differs from its fused
one by up to 1.6e-2 in bf16, as JAX's two branches do.

JAX is imported inside the tests that compare with it, so that the CUDA
tests run on a machine without JAX:
    python -m pytest --noconftest -m cuda tests/test_torch_gru.py
"""

import os

import numpy as np
import pytest
import torch

from droid_slam_tpu_torch.models import nets as tnets
from droid_slam_tpu_torch.models import weights as tweights
from droid_slam_tpu_torch.ops import gru as tgru
from droid_slam_tpu_torch.ops import gru_cuda

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "r5_006000.npz")
E, h, w = 3, 8, 16
ATOL = {"f32": 1e-5, "bf16": 1e-2}
TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _epilogue_inputs(seed):
    """NHWC numpy operands of both epilogues, at the scale of the GRU's
    pre-activations (a few units) and a hidden state in (-1, 1)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (2.0 * rng.normal(size=s)).astype(np.float32)
    return dict(zrc=f(E, h, w, 256), cf=f(E, h, w, 384),
                pre_zr=f(E, h, w, 256), pre_q=f(E, h, w, 128),
                qc=f(E, h, w, 128), gzr=f(E, 256), gq=f(E, 128),
                net=np.tanh(f(E, h, w, 128)),
                z=(1 / (1 + np.exp(-f(E, h, w, 128)))).astype(np.float32))


def _nchw(a, dt):
    t = torch.as_tensor(a)
    if t.dim() == 4:
        t = t.permute(0, 3, 1, 2)
    return t.to(TORCH_DT[dt]).contiguous()


def _np(t):
    return t.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_twins_match_the_pallas_kernels(dt):
    import jax.numpy as jnp
    from droid_slam_tpu.ops import gru_pallas

    x = _epilogue_inputs(1)
    jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
    j = {k: jnp.asarray(v, jdt) for k, v in x.items()}
    t = {k: _nchw(v, dt) for k, v in x.items()}

    jz, jrnet = gru_pallas.gru_epilogue_a(j["zrc"], j["cf"], j["pre_zr"],
                                          j["net"], j["gzr"], interpret=True)
    z, rnet = tgru.gru_epilogue_a_plain(t["zrc"], t["cf"], t["pre_zr"],
                                        t["net"], t["gzr"])
    jout = gru_pallas.gru_epilogue_b(j["qc"], j["cf"], j["pre_q"], j["net"],
                                     j["z"], j["gq"], interpret=True)
    out = tgru.gru_epilogue_b_plain(t["qc"], t["cf"], t["pre_q"], t["net"],
                                    t["z"], t["gq"])
    for got, want in ((z, jz), (rnet, jrnet), (out, jout)):
        assert got.dtype == TORCH_DT[dt] and got.shape == (E, 128, h, w)
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   atol=ATOL[dt], rtol=0)


@pytest.fixture(scope="module")
def jax_params():
    if not os.path.exists(CKPT):
        import jax
        from droid_slam_tpu.models import nets as jnets
        return {k: np.asarray(v)
                for k, v in jnets.init_params(jax.random.PRNGKey(0)).items()}
    with np.load(CKPT) as d:
        return {k: d[k] for k in d.files}


def _gru_inputs(seed):
    rng = np.random.default_rng(seed)
    net = np.tanh(rng.normal(size=(E, h, w, 128))).astype(np.float32)
    ctx = np.maximum(rng.normal(size=(E, h, w, 128)), 0).astype(np.float32)
    cfin = np.maximum(rng.normal(size=(E, h, w, 192)), 0).astype(np.float32)
    return net, ctx, cfin


# f32: three convolutions summed in another order; bf16: the convolutions
# round their outputs to bf16 in both frameworks (one ulp, ~4e-3 at the
# pre-activations' scale), which the gates carry into the new state: 3e-2,
# the bf16 bound of tests/test_gru_pallas.py
GRU_ATOL = {"f32": 1e-5, "bf16": 3e-2}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fused_conv_gru_matches_jax_pallas_path(monkeypatch, jax_params, dt):
    import jax.numpy as jnp
    from droid_slam_tpu.models import nets as jnets

    monkeypatch.setattr(jnets, "_GRU_PALLAS_ENV", "interpret")
    net, ctx, cfin = _gru_inputs(2)
    jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
    jp = {k: jnp.asarray(v) for k, v in jax_params.items()}
    jnet, jctx, jcf = (jnp.asarray(a, jdt) for a in (net, ctx, cfin))
    want = jnets.conv_gru(jp, jnet, jcf, pre=jnets.gru_context_pre(jp, jctx),
                          pallas_ok=True)

    tp = tweights.from_jax_params(jax_params)
    tnet, tctx, tcf = (_nchw(a, dt) for a in (net, ctx, cfin))
    pre = tnets.gru_context_pre(tp, tctx)
    merged = tnets.merge_update(tp)
    got = tnets.conv_gru(tp, tnet, tcf, merged, pre=pre, fused_epilogue=True)
    plain = tnets.conv_gru(tp, tnet, tcf, merged, pre=pre)
    assert got.dtype == TORCH_DT[dt] and got.shape == (E, 128, h, w)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, atol=GRU_ATOL[dt], rtol=0)
    # the port's own default branch computes the same function
    np.testing.assert_allclose(_np(got), _np(plain), atol=GRU_ATOL[dt],
                               rtol=0)
    assert np.abs(want - net).max() > 0.05       # the state did move


def test_update_module_passes_the_flag_only_with_pre(monkeypatch, jax_params):
    """update_module takes the fused branch with ``pre`` and the plain
    320-channel path without it, as the JAX package does. The corr and flow
    features arrive channels-last, as the factor graph passes them; the
    kernels still get contiguous NCHW operands (they refuse others)."""
    calls = []
    orig = gru_cuda.gru_epilogue_a

    def spy(*a):
        calls.append(all(t.is_contiguous() for t in a))
        return orig(*a)

    monkeypatch.setattr(gru_cuda, "gru_epilogue_a", spy)
    tp = tweights.from_jax_params(jax_params)
    net, ctx, _ = _gru_inputs(3)
    rng = np.random.default_rng(3)
    corr, flow = (_nchw(rng.normal(size=(E, h, w, c)).astype(np.float32),
                        "f32").to(memory_format=torch.channels_last)
                  for c in (196, 4))
    tnet, tctx = _nchw(net, "f32"), _nchw(ctx, "f32")
    tnets.update_module(tp, tnet, tctx, corr, flow, fused_epilogue=True)
    assert calls == []
    pre = tnets.gru_context_pre(tp, tctx)
    fused = tnets.update_module(tp, tnet, None, corr, flow, pre=pre,
                                fused_epilogue=True)
    assert calls == [True]
    plain = tnets.update_module(tp, tnet, None, corr, flow, pre=pre)
    for a, b in zip(fused, plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)


def test_wrappers_route_cpu_tensors_to_the_twins():
    x = {k: _nchw(v, "f32") for k, v in _epilogue_inputs(4).items()}
    before = gru_cuda.LAUNCHES_A, gru_cuda.LAUNCHES_B
    z, rnet = gru_cuda.gru_epilogue_a(x["zrc"], x["cf"], x["pre_zr"],
                                      x["net"], x["gzr"])
    out = gru_cuda.gru_epilogue_b(x["qc"], x["cf"], x["pre_q"], x["net"],
                                  x["z"], x["gq"])
    assert (gru_cuda.LAUNCHES_A, gru_cuda.LAUNCHES_B) == before
    wz, wr = tgru.gru_epilogue_a_plain(x["zrc"], x["cf"], x["pre_zr"],
                                       x["net"], x["gzr"])
    torch.testing.assert_close(z, wz, atol=0, rtol=0)
    torch.testing.assert_close(rnet, wr, atol=0, rtol=0)
    torch.testing.assert_close(
        out, tgru.gru_epilogue_b_plain(x["qc"], x["cf"], x["pre_q"],
                                       x["net"], x["z"], x["gq"]),
        atol=0, rtol=0)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    meta = torch.device("meta")
    x = {k: _nchw(v, "f32").to(meta) for k, v in _epilogue_inputs(5).items()}
    a = (x["zrc"], x["cf"], x["pre_zr"], x["net"], x["gzr"])
    b = (x["qc"], x["cf"], x["pre_q"], x["net"], x["z"], x["gq"])
    with pytest.raises(ValueError, match="unsupported device"):
        gru_cuda.gru_epilogue_a(*a)
    with pytest.raises(ValueError, match="unsupported device"):
        gru_cuda.gru_epilogue_b(*b)
    with pytest.raises(ValueError, match="cf must be contiguous"):
        gru_cuda.gru_epilogue_a(a[0], a[1][:, :256], *a[2:])
    with pytest.raises(ValueError, match="pre_q must be contiguous"):
        gru_cuda.gru_epilogue_b(b[0], b[1], b[2].transpose(2, 3), *b[3:])
    with pytest.raises(ValueError, match="zrc must be"):
        gru_cuda.gru_epilogue_a(a[0].half(), *a[1:])
    with pytest.raises(ValueError, match="gate bias"):
        gru_cuda.gru_epilogue_b(*b[:5], b[5][:, :64])
    with pytest.raises(ValueError, match="dtype"):
        gru_cuda.gru_epilogue_b(*(t.double() for t in b))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("hw", [(40, 64), (5, 7)])
def test_cuda_kernels_match_plain_twins(dt, hw):
    """Both variants: 8-pixel vectors (40x64, the main path's plane) and
    one pixel per thread (5x7 = 35 pixels, not a multiple of 8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    rng = np.random.default_rng(6)
    dev = torch.device("cuda")
    hh, ww = hw
    f = lambda c: (2.0 * torch.as_tensor(rng.normal(size=(4, c, hh, ww))
                                         .astype(np.float32))).to(
        dev, TORCH_DT[dt])
    zrc, cf, pre_zr, qc, pre_q = f(256), f(384), f(256), f(128), f(128)
    net, z = torch.tanh(f(128)), torch.sigmoid(f(128))
    gzr = torch.as_tensor(rng.normal(size=(4, 256)).astype(np.float32)).to(
        dev, TORCH_DT[dt])
    gq = gzr[:, :128].contiguous()
    before = gru_cuda.LAUNCHES_A, gru_cuda.LAUNCHES_B
    got_a = gru_cuda.gru_epilogue_a(zrc, cf, pre_zr, net, gzr)
    got_b = gru_cuda.gru_epilogue_b(qc, cf, pre_q, net, z, gq)
    torch.cuda.synchronize()
    assert (gru_cuda.LAUNCHES_A, gru_cuda.LAUNCHES_B) == (before[0] + 1,
                                                          before[1] + 1)
    want_a = tgru.gru_epilogue_a_plain(zrc, cf, pre_zr, net, gzr)
    want_b = tgru.gru_epilogue_b_plain(qc, cf, pre_q, net, z, gq)
    for g, wnt in zip((*got_a, got_b), (*want_a, want_b)):
        torch.testing.assert_close(g.float(), wnt.float(), atol=ATOL[dt],
                                   rtol=0)
