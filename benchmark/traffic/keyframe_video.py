"""A video of keyframes as the global bundle adjustment finds it at the end
of a long sequence, drawn from the seed as the port's
``tools/bench_global_ba_torch.py::synthetic_video`` lays it out: poses
along a smooth random walk (the box walk's, step 0.04 and rotation step
0.01 a keyframe, the traffic's walk), disparities U(0.8, 1.2), from the
seed as the fields below, intrinsics [0.8w, 0.8w, w/2,
h/2] at the feature scale, features N(0, 1) and GRU states and contexts
N(0, 0.1^2). The fields are drawn on the device by one generator, in a few
large calls; the poses on the host."""

from __future__ import annotations

import numpy as np

from .box_walk import random_trajectory


def _quat(R):
    """Rotation matrices [N,3,3] -> unit quaternions [N,4] (x, y, z, w),
    by Shepperd's method (scipy's ``Rotation.from_matrix``, to float32
    rounding): from the largest of the diagonal and the trace."""
    import torch
    R = np.asarray(R, np.float64)
    q = np.empty((len(R), 4))
    for k, m in enumerate(R):
        d = [m[0, 0], m[1, 1], m[2, 2], np.trace(m)]
        i = int(np.argmax(d))
        if i == 3:
            q[k] = [m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1],
                    1 + d[3]]
        else:
            j, l = (i + 1) % 3, (i + 2) % 3
            q[k, i] = 1 - d[3] + 2 * m[i, i]
            q[k, j] = m[j, i] + m[i, j]
            q[k, l] = m[l, i] + m[i, l]
            q[k, 3] = m[l, j] - m[j, l]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return torch.as_tensor(q, dtype=torch.float32)


def poses_w2c(Rs, ts):
    """World-to-camera [t, q] of camera-to-world (Rs, ts)."""
    import torch
    Rt = np.transpose(Rs, (0, 2, 1))
    t = -np.einsum("nij,nj->ni", Rt, ts)
    return torch.cat([torch.as_tensor(t, dtype=torch.float32), _quat(Rt)],
                     -1)


def make(t, image_size, walk_seed, seed, step, rot_step, device):
    """{poses [t,7], disps [t,h,w], intrinsics [4], fmaps [t,1,128,h,w],
    nets, inps [t,128,h,w]} (bf16 features) on ``device``: the poses of
    ``walk_seed``'s walk, the same for every run of a traffic mix (it sets
    how many edges the proposal finds), the fields from ``seed``."""
    import torch
    H, W = image_size
    h, w = H // 8, W // 8
    Rs, ts = random_trajectory(t, np.random.default_rng(walk_seed),
                               step=step, rot_step=rot_step)
    g = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    bf16 = torch.bfloat16
    return {
        "poses": poses_w2c(Rs, ts).to(device),
        "disps": 0.8 + 0.4 * torch.rand((t, h, w), generator=g,
                                        device=device),
        "intrinsics": torch.tensor([0.8 * w, 0.8 * w, w / 2, h / 2],
                                   device=device),
        "fmaps": torch.randn((t, 1, 128, h, w), generator=g,
                             device=device).to(bf16),
        "nets": (0.1 * torch.randn((t, 128, h, w), generator=g,
                                   device=device)).to(bf16),
        "inps": (0.1 * torch.randn((t, 128, h, w), generator=g,
                                   device=device)).to(bf16),
    }
