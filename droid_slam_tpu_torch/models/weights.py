"""Parameters: the JAX package's ``.npz`` checkpoints, the reference's
``.pth`` state_dicts, or a seeded random initialization with the
reference's scheme.

The JAX package stores conv weights HWIO (``droid_slam_tpu/models/
weights.py``); PyTorch convolutions take OIHW. ``from_jax_params`` carries a
JAX parameter dict across and ``to_jax_params`` is its exact inverse. A
``.pth`` is already OIHW and is read as it is (``load_pth``). The trainer
writes ``.npz`` weights in the JAX package's layout (``save_npz``) and its
resumable state in a file of its own (``save_train_state``).
"""

from __future__ import annotations

import os

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


def save_npz(path: str, params: dict) -> None:
    """Write ``params`` with the JAX package's key names and layouts (HWIO
    convolutions), so that either package loads the file."""
    np.savez(path, **to_jax_params(params))


def save_train_state(path: str, params: dict, opt_state: dict, step: int,
                     rng_state=None) -> None:
    """The resumable training state: parameters, the optimizer's state
    (``Optimizer.state_dict()``, which holds the schedule's count), the
    step and the data generator's state. Written to a temporary file and
    renamed, so that a crash mid-write leaves the last good state."""
    payload = {"params": {k: v.detach().cpu() for k, v in params.items()},
               "opt_state": opt_state, "step": int(step),
               "rng_state": rng_state}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_train_state(path: str, device="cpu"):
    """(params on ``device``, opt_state, step, rng_state) written by
    ``save_train_state``."""
    payload = torch.load(path, map_location=device, weights_only=False)
    return (payload["params"], payload["opt_state"], payload["step"],
            payload["rng_state"])


# the reference network's flow and weight heads have 3 output rows; the
# tracker reads 2 (droid_slam_tpu/models/weights.py:14,24-27)
_HEAD_SLICE = ("update.weight.2", "update.delta.2")


def load_pth(path: str) -> dict:
    """A reference-format ``droid.pth`` state_dict: the ``module.`` prefix
    stripped and the 3-row heads sliced to 2 rows, convolutions kept OIHW."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    state = {k.replace("module.", ""): v for k, v in state.items()}
    for head in _HEAD_SLICE:
        if head + ".weight" in state and state[head + ".weight"].shape[0] == 3:
            state[head + ".weight"] = state[head + ".weight"][:2]
            state[head + ".bias"] = state[head + ".bias"][:2]
    return {k: v.float().contiguous() for k, v in state.items()}


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
    """Parameters from ``path`` (a ``.npz`` of the JAX package's, any other
    file a ``.pth`` state_dict), or seeded random ones when ``path`` is
    None, on ``device``."""
    if path is None:
        params = init_params(0)
    elif str(path).endswith(".npz"):
        params = load_npz(path)
    else:
        params = load_pth(path)
    return {k: v.to(device) for k, v in params.items()}
