"""Parameters: the JAX package's ``.npz`` checkpoints, or a seeded random
initialization with the reference's scheme.

The JAX package stores conv weights HWIO (``droid_slam_tpu/models/
weights.py``); PyTorch convolutions take OIHW. ``from_jax_params`` carries a
JAX parameter dict across and ``to_jax_params`` is its exact inverse.
"""

from __future__ import annotations

import numpy as np
import torch

from .nets import CORR_PLANES, DIM


def from_jax_params(params: dict) -> dict:
    """{name: np.ndarray (HWIO convs)} -> {name: f32 tensor (OIHW convs)}."""
    out = {}
    for k, v in params.items():
        arr = np.asarray(v, np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        out[k] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def to_jax_params(state: dict) -> dict:
    """Inverse of from_jax_params."""
    out = {}
    for k, v in state.items():
        arr = v.detach().cpu().numpy()
        if arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)
        out[k] = np.ascontiguousarray(arr)
    return out


def load_npz(path: str) -> dict:
    with np.load(path) as data:
        return from_jax_params({k: data[k] for k in data.files})


def _encoder_shapes(prefix, out_dim):
    shp = {f"{prefix}.conv1": (DIM, 3, 7, 7),
           f"{prefix}.conv2": (out_dim, 4 * DIM, 1, 1)}
    dims = [(DIM, DIM, 1), (DIM, 2 * DIM, 2), (2 * DIM, 4 * DIM, 2)]
    for li, (cin, cout, stride) in enumerate(dims, start=1):
        for blk in range(2):
            ci = cin if blk == 0 else cout
            base = f"{prefix}.layer{li}.{blk}"
            shp[f"{base}.conv1"] = (cout, ci, 3, 3)
            shp[f"{base}.conv2"] = (cout, cout, 3, 3)
            if blk == 0 and stride != 1:
                shp[f"{base}.downsample.0"] = (cout, ci, 1, 1)
    return shp


def param_shapes() -> dict:
    """OIHW shape of every conv of the network, by state_dict prefix."""
    shp = {}
    shp.update(_encoder_shapes("fnet", 128))
    shp.update(_encoder_shapes("cnet", 256))
    shp.update({
        "update.corr_encoder.0": (128, CORR_PLANES, 1, 1),
        "update.corr_encoder.2": (128, 128, 3, 3),
        "update.flow_encoder.0": (128, 4, 7, 7),
        "update.flow_encoder.2": (64, 128, 3, 3),
        "update.weight.0": (128, 128, 3, 3),
        "update.weight.2": (2, 128, 3, 3),
        "update.delta.0": (128, 128, 3, 3),
        "update.delta.2": (2, 128, 3, 3),
        "update.gru.convz": (128, 128 + 320, 3, 3),
        "update.gru.convr": (128, 128 + 320, 3, 3),
        "update.gru.convq": (128, 128 + 320, 3, 3),
        "update.gru.w": (128, 128, 1, 1),
        "update.gru.convz_glo": (128, 128, 1, 1),
        "update.gru.convr_glo": (128, 128, 1, 1),
        "update.gru.convq_glo": (128, 128, 1, 1),
        "update.agg.conv1": (128, 128, 3, 3),
        "update.agg.conv2": (128, 128, 3, 3),
        "update.agg.eta.0": (1, 128, 3, 3),
        "update.agg.upmask.0": (8 * 8 * 9, 128, 1, 1),
    })
    return shp


def init_params(seed: int = 0) -> dict:
    """Kaiming-normal (fan_out) weights and zero biases, from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    params = {}
    for name, shape in sorted(param_shapes().items()):
        cout, _, kh, kw = shape
        std = (2.0 / (kh * kw * cout)) ** 0.5
        params[name + ".weight"] = torch.randn(shape, generator=gen) * std
        params[name + ".bias"] = torch.zeros(cout)
    return params


def load(path, device) -> dict:
    """Parameters from ``path`` (``.npz``), or seeded random ones when
    ``path`` is None, on ``device``."""
    params = init_params(0) if path is None else load_npz(path)
    return {k: v.to(device) for k, v in params.items()}
