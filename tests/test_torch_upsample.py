"""The port's convex upsampling (``--upsample``) against the JAX package.

``cvx_upsample`` and ``upsample_disp`` run in f32 in both (JAX's einsum at
``precision="highest"``; the port's products and sum over the 9
neighbours): held to 1e-5. The upsampling-mask head (``graph_agg``'s
``update.agg.upmask.0``) runs in the network's dtype: held to 1e-4 of its
range in f32 and, in bf16, to update_module's bf16 bound (3e-2 of the
range, tests/test_torch_terminate.py).

End to end, the RGB-D run of tests/test_torch_stereo_rgbd.py (the TUM
demo's use: a depth map per frame and ``--upsample``) holds the pipeline's
``disps_up`` after the tracking slice and after ``terminate()`` against
JAX's, with its bounds and readings; the stereo run there upsamples too.
"""

import os

import numpy as np
import pytest
import torch

from droid_slam_tpu_torch.models import nets as tnets
from droid_slam_tpu_torch.models import weights as tweights

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "r5_006000.npz")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several test processes at once,
    and PyTorch's CPU kernels, each process spinning a thread per core,
    slow down many times over when they outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    if os.path.exists(CKPT):
        with np.load(CKPT) as d:
            return {k: d[k] for k in d.files}
    import jax
    from droid_slam_tpu.models import nets as jnets
    return {k: np.asarray(v)
            for k, v in jnets.init_params(jax.random.PRNGKey(0)).items()}


def _nchw(a):
    return torch.as_tensor(a).permute(0, 3, 1, 2).contiguous()


def _mask(rng, N, h, w):
    return (3.0 * rng.normal(size=(N, h, w, 576))).astype(np.float32)


@pytest.mark.parametrize("dim", [1, 3])
def test_cvx_upsample_matches_jax(dim):
    import jax.numpy as jnp
    from droid_slam_tpu.models import nets as jnets

    rng = np.random.default_rng(51)
    N, h, w = 3, 5, 7
    data = rng.uniform(0.1, 2.0, size=(N, h, w, dim)).astype(np.float32)
    mask = _mask(rng, N, h, w)
    want = np.asarray(jnets.cvx_upsample(jnp.asarray(data),
                                         jnp.asarray(mask)))
    got = tnets.cvx_upsample(_nchw(data), _nchw(mask))
    assert got.shape == (N, dim, 8 * h, 8 * w) and got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5)


def test_upsample_disp_matches_jax_and_stays_in_its_neighbourhood():
    import jax.numpy as jnp
    from droid_slam_tpu.models import nets as jnets

    rng = np.random.default_rng(52)
    N, h, w = 4, 8, 12
    disp = rng.uniform(0.1, 2.0, size=(N, h, w)).astype(np.float32)
    mask = _mask(rng, N, h, w)
    want = np.asarray(jnets.upsample_disp(jnp.asarray(disp),
                                          jnp.asarray(mask)))
    got = tnets.upsample_disp(torch.as_tensor(disp), _nchw(mask))
    assert got.shape == (N, 8 * h, 8 * w)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # a convex combination of the 3x3 neighbourhood (zero padded)
    pad = np.pad(disp, ((0, 0), (1, 1), (1, 1)))
    win = np.stack([pad[:, dy:dy + h, dx:dx + w] for dy in range(3)
                    for dx in range(3)])
    up_hi = np.repeat(np.repeat(win.max(0), 8, 1), 8, 2)
    assert (got.numpy() <= up_hi + 1e-6).all()
    assert (got.numpy() >= -1e-6).all()
    # the head writes its mask in bf16; the upsampling widens it to f32
    bf = tnets.upsample_disp(torch.as_tensor(disp),
                             _nchw(mask).to(torch.bfloat16))
    assert bf.dtype == torch.float32


@pytest.mark.parametrize("bf16", [False, True])
def test_upmask_head_matches_jax(jax_params, bf16):
    import jax.numpy as jnp
    from droid_slam_tpu.models import nets as jnets

    rng = np.random.default_rng(53)
    E, h, w = 5, 8, 12
    net = np.tanh(rng.normal(size=(E, h, w, 128))).astype(np.float32)
    ii = np.array([0, 0, 2, 3, 3])
    jd = jnp.bfloat16 if bf16 else jnp.float32
    td = torch.bfloat16 if bf16 else torch.float32
    jp = {k: jnp.asarray(v) for k, v in jax_params.items()}
    want_eta, want_up = jnets.graph_agg(jp, jnp.asarray(net, jd),
                                        jnp.asarray(ii), 4)
    got_eta, got_up = tnets.graph_agg(tweights.from_jax_params(jax_params),
                                      _nchw(net).to(td), torch.as_tensor(ii),
                                      4, compute_upmask=True)
    assert got_up.shape == (4, 576, h, w) and got_up.dtype == td
    want_up = np.asarray(want_up, np.float32)
    tol = 3e-2 if bf16 else 1e-4
    np.testing.assert_allclose(got_up.float().permute(0, 2, 3, 1).numpy(),
                               want_up, atol=tol * np.abs(want_up).max())
    np.testing.assert_allclose(got_eta.float().numpy(),
                               np.asarray(want_eta, np.float32),
                               rtol=2e-2 if bf16 else 1e-4, atol=1e-6)
    # the head runs only on request
    assert tnets.graph_agg(tweights.from_jax_params(jax_params),
                           _nchw(net).to(td), torch.as_tensor(ii), 4)[1] \
        is None


def test_update_module_returns_the_mask_on_request(jax_params):
    rng = np.random.default_rng(54)
    E, h, w = 3, 8, 12
    params = tweights.from_jax_params(jax_params)
    net = _nchw(np.tanh(rng.normal(size=(E, h, w, 128))).astype(np.float32))
    inp = _nchw(np.maximum(rng.normal(size=(E, h, w, 128)), 0)
                .astype(np.float32))
    corr = _nchw(rng.normal(size=(E, h, w, 196)).astype(np.float32))
    ii = torch.as_tensor([0, 1, 1])
    plain = tnets.update_module(params, net, inp, corr, ii=ii, num_frames=2)
    with_mask = tnets.update_module(params, net, inp, corr, ii=ii,
                                    num_frames=2, compute_upmask=True)
    assert len(plain) == len(with_mask) == 5 and plain[4] is None
    for a, b in zip(plain[:4], with_mask[:4]):
        assert torch.equal(a, b)
    _, want = tnets.graph_agg(params, with_mask[0], ii, 2,
                              compute_upmask=True)
    assert torch.equal(with_mask[4], want)


def test_rgbd_track_and_terminate_with_upsample_match_jax():
    from test_torch_stereo_rgbd import check_track_and_terminate
    check_track_and_terminate("rgbd")
