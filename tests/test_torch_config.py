"""The port's presets and weight loaders against the JAX package.

Each preset of ``droid_slam_tpu_torch.config.PRESETS`` equals JAX's field by
field; the port leaves out only the knobs of modes it does not run. A
reference-format ``droid.pth`` (``module.`` prefixes, 3-row flow and weight
heads, OIHW convolutions), written here with ``torch.save`` from the
checkpoint's parameters, loads in the port to exactly those parameters, and
to exactly what JAX's ``load_torch_checkpoint`` reads from the same file.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from droid_slam_tpu_torch import config as tconfig
from droid_slam_tpu_torch.models import weights as tweights

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "r5_006000.npz")
# JAX fields of modes the port does not run: none since the edge-parallel
# frontend (parallel/frontend.py)
JAX_ONLY = set()
# the port's flags for what JAX selects by environment variable
# (DROID_GRU_PALLAS, DROID_FUSED_FRAME, DROID_SPEC_FRAME)
PORT_ONLY = {"gru_fused_epilogue", "fused_frame", "spec_frame"}


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("name", ["default", "demo", "tartanair", "euroc",
                                  "tum", "eth3d"])
def test_presets_equal_jax_field_by_field(name):
    from droid_slam_tpu import config as jconfig

    if name == "default":
        j, t = jconfig.DroidConfig(), tconfig.DroidConfig()
    else:
        assert set(tconfig.PRESETS) == set(jconfig.PRESETS)
        j, t = jconfig.PRESETS[name], tconfig.PRESETS[name]
    jf, tf = _fields(j), _fields(t)
    assert set(jf) - set(tf) == JAX_ONLY
    assert set(tf) - set(jf) == PORT_ONLY
    for k in set(jf) & set(tf):
        assert tf[k] == jf[k], (name, k)
    assert tf["gru_fused_epilogue"] is False
    assert tf["fused_frame"] is None and tf["spec_frame"] is None


def test_edge_parallel_defaults_to_serial_as_jax():
    from droid_slam_tpu import config as jconfig

    assert tconfig.DroidConfig().edge_parallel \
        == jconfig.DroidConfig().edge_parallel == 0
    for name, cfg in tconfig.PRESETS.items():
        assert cfg.edge_parallel == jconfig.PRESETS[name].edge_parallel


def test_scale_factors_equal_jax():
    from droid_slam_tpu import config as jconfig

    assert tconfig.STEREO_SCALE_FACTOR == jconfig.STEREO_SCALE_FACTOR
    assert tconfig.EUROC_SCALE_FACTOR == jconfig.EUROC_SCALE_FACTOR


@pytest.fixture(scope="module")
def params():
    """The checkpoint's parameters (OIHW), or the seeded init without it."""
    if os.path.exists(CKPT):
        return tweights.load_npz(CKPT)
    return tweights.init_params(0)


@pytest.fixture(scope="module")
def pth(params, tmp_path_factory):
    """A reference-format state_dict: ``module.`` keys and 3-row heads (the
    third row holds values the tracker never reads)."""
    gen = torch.Generator().manual_seed(0)
    state = {}
    for k, v in params.items():
        if k.startswith(tweights._HEAD_SLICE):
            extra = torch.randn((1,) + tuple(v.shape[1:]), generator=gen)
            v = torch.cat([v, extra])
        state["module." + k] = v.clone()
    path = tmp_path_factory.mktemp("pth") / "droid.pth"
    torch.save(state, path)
    return str(path)


def test_pth_loads_to_the_npz_parameters_exactly(params, pth):
    got = tweights.load(pth, "cpu")
    assert set(got) == set(params)
    for k, v in params.items():
        assert got[k].dtype == torch.float32 and got[k].is_contiguous(), k
        assert torch.equal(got[k], v), k
    assert got["update.delta.2.weight"].shape[0] == 2
    assert got["update.weight.2.bias"].shape == (2,)


def test_pth_loads_as_jax_loads_it(pth):
    from droid_slam_tpu.models import weights as jweights

    want = jweights.load(pth)                       # HWIO, JAX's loader
    got = tweights.to_jax_params(tweights.load(pth, "cpu"))
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(got[k], np.asarray(v)), k


def test_droid_takes_a_pth(params, pth):
    from droid_slam_tpu_torch.slam.droid import Droid

    droid = Droid(tconfig.DroidConfig(image_size=(64, 96), buffer=4,
                                      weights=pth), device="cpu")
    for k, v in params.items():
        assert torch.equal(droid.params[k], v), k
