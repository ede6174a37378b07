"""SE(3), pinhole projection with its Jacobians, and the frame distance, as
plain functions on tensors of any float dtype.

Poses are ``[tx, ty, tz, qx, qy, qz, qw]`` (world to camera); disparities
are inverse depths on the 1/8-resolution grid; intrinsics one ``[4]``
vector ``[fx, fy, cx, cy]`` at that resolution; homogeneous points
``[x, y, 1, d]``. Written from DROID-SLAM's projective model
(``geom/projective_ops.py``, ``geom/graph_utils.py::compute_distance``
of princeton-vl/DROID-SLAM): a left retraction ``exp(xi) * g``, edges
(i, j) mapping frame i's pixels into frame j with ``G_ij = G_j G_i^-1``.
"""

from __future__ import annotations

import torch

MIN_DEPTH = 0.2      # the update operator's validity
MIN_DEPTH_BA = 0.25  # the bundle adjustment's and the frame distance's


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def quat_mul(q1, q2):
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
                        w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
                        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], dim=-1)


def quat_rotate(q, v):
    qv, w = q[..., :3], q[..., 3:4]
    qv, v = torch.broadcast_tensors(qv, v)
    uv = 2.0 * _cross(qv, v)
    return v + w * uv + _cross(qv, uv)


def quat_matrix(q):
    x, y, z, w = q.unbind(-1)
    m = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y), 2 * (x * y + w * z),
                     1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                     2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def mul(a, b):
    return torch.cat([quat_rotate(a[..., 3:], b[..., :3]) + a[..., :3],
                      quat_mul(a[..., 3:], b[..., 3:])], dim=-1)


def inv(g):
    qi = torch.cat([-g[..., 3:6], g[..., 6:7]], dim=-1)
    return torch.cat([-quat_rotate(qi, g[..., :3]), qi], dim=-1)


def act(g, X):
    """Homogeneous points X [..., 4]: [R X + w t, w]."""
    y = quat_rotate(g[..., 3:], X[..., :3]) + X[..., 3:4] * g[..., :3]
    return torch.cat([y, X[..., 3:4].expand(y.shape[:-1] + (1,))], dim=-1)


def exp(xi):
    """se(3) tangent [tau, phi] -> pose, by the closed forms."""
    tau, phi = xi[..., :3], xi[..., 3:]
    th2 = (phi * phi).sum(-1, keepdim=True)
    small = th2 < 1e-8
    th2s = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(th2s)
    half = 0.5 * th
    imag = torch.where(small, 0.5 - th2 / 48.0, torch.sin(half) / th)
    real = torch.where(small, 1.0 - th2 / 8.0, torch.cos(half))
    a = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2s)
    b = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (th - torch.sin(th)) / (th * th2s))
    pt = _cross(phi, tau)
    t = tau + a * pt + b * _cross(phi, pt)
    return torch.cat([t, imag * phi, real], dim=-1)


def log(g):
    t, q = g[..., :3], g[..., 3:]
    sign = torch.where(q[..., 3:] < 0, -1.0, 1.0).to(q.dtype)
    qv, qw = q[..., :3] * sign, q[..., 3:] * sign
    s2 = (qv * qv).sum(-1, keepdim=True)
    s = torch.sqrt(s2)
    small = s2 < 1e-12
    k = torch.where(small, 2.0 / qw * (1.0 - s2 / (3.0 * qw * qw)),
                    2.0 * torch.atan2(s, qw)
                    / torch.where(small, torch.ones_like(s), s))
    phi = k * qv
    th2 = (phi * phi).sum(-1, keepdim=True)
    small = th2 < 1e-8
    th2s = torch.where(small, torch.ones_like(th2), th2)
    half = 0.5 * torch.sqrt(th2s)
    c = torch.where(small, 1.0 / 12.0 + th2 / 720.0,
                    (1.0 - half * torch.cos(half) / torch.sin(half)) / th2s)
    pt = _cross(phi, t)
    return torch.cat([t - 0.5 * pt + c * _cross(phi, pt), phi], dim=-1)


def retr(g, xi):
    return mul(exp(xi), g)


def adj(g):
    """Ad(g) [..., 6, 6] = [[R, [t]x R], [0, R]] for [tau, phi] tangents."""
    R = quat_matrix(g[..., 3:])
    tx, ty, tz = g[..., 0], g[..., 1], g[..., 2]
    o = torch.zeros_like(tx)
    S = torch.stack([o, -tz, ty, tz, o, -tx, -ty, tx, o],
                    dim=-1).reshape(tx.shape + (3, 3))
    top = torch.cat([R, S @ R], dim=-1)
    return torch.cat([top, torch.cat([torch.zeros_like(R), R], dim=-1)],
                     dim=-2)


def coords_grid(h, w, dtype, device):
    y, x = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                          torch.arange(w, dtype=dtype, device=device),
                          indexing="ij")
    return torch.stack([x, y], dim=-1)


def iproj(disps, intr):
    h, w = disps.shape[-2:]
    fx, fy, cx, cy = intr
    g = coords_grid(h, w, disps.dtype, disps.device)
    x = ((g[..., 0] - cx) / fx).expand_as(disps)
    y = ((g[..., 1] - cy) / fy).expand_as(disps)
    return torch.stack([x, y, torch.ones_like(disps), disps], dim=-1)


def warp(poses, disps, intr, ii, jj, min_depth=MIN_DEPTH, jacobians=False):
    """Frame ii's pixels in frame jj: coords [E,h,w,2], valid [E,h,w], and
    with ``jacobians`` (Ji, Jj [E,h,w,2,6], Jz [E,h,w,2]) of the coords by
    left perturbations of poses ii and jj and by the disparity of ii."""
    fx, fy, cx, cy = intr
    X0 = iproj(disps[ii], intr)
    Gij = mul(poses[jj], inv(poses[ii]))
    X1 = act(Gij[:, None, None], X0)
    x, y, z, hc = X1.unbind(-1)
    zc = torch.where(z < 0.5 * min_depth, torch.ones_like(z), z)
    d = 1.0 / zc
    coords = torch.stack([fx * x * d + cx, fy * y * d + cy], dim=-1)
    valid = (z > min_depth) & (X0[..., 2] > min_depth)
    if not jacobians:
        return coords, valid, None
    d2, o = d * d, torch.zeros_like(d)
    Ju = torch.stack([fx * hc * d, o, -fx * x * hc * d2, -fx * x * y * d2,
                      fx * (1 + x * x * d2), -fx * y * d], dim=-1)
    Jv = torch.stack([o, fy * hc * d, -fy * y * hc * d2,
                      -fy * (1 + y * y * d2), fy * x * y * d2, fy * x * d],
                     dim=-1)
    Jj = torch.stack([Ju, Jv], dim=-2)
    Ji = -Jj @ adj(Gij)[:, None, None]
    t = Gij[:, None, None, :3]
    Jz = torch.stack([fx * (t[..., 0] * d - t[..., 2] * x * d2),
                      fy * (t[..., 1] * d - t[..., 2] * y * d2)], dim=-1)
    return coords, valid, (Ji, Jj, Jz)


def _directed_distance(poses, disps, intr, ii, jj, beta):
    h, w = disps.shape[-2:]
    fx, fy, cx, cy = intr
    g = coords_grid(h, w, disps.dtype, disps.device)
    X0 = iproj(disps[ii], intr)
    Gij = mul(poses[jj], inv(poses[ii]))

    def flow(X1):
        z = X1[..., 2]
        zs = torch.where(z <= 0, torch.ones_like(z), z)
        du = fx * X1[..., 0] / zs + cx - g[..., 0]
        dv = fy * X1[..., 1] / zs + cy - g[..., 1]
        return torch.sqrt(du * du + dv * dv), (z > MIN_DEPTH_BA).to(z.dtype)

    mf, vf = flow(act(Gij[:, None, None], X0))
    mt, vt = flow(torch.cat([X0[..., :3] + X0[..., 3:] * Gij[:, None, None,
                                                             :3],
                             X0[..., 3:]], dim=-1))
    acc = beta * (mf * vf).sum((-2, -1)) + (1 - beta) * (mt * vt).sum((-2,
                                                                       -1))
    val = beta * vf.sum((-2, -1)) + (1 - beta) * vt.sum((-2, -1))
    dist = acc / torch.where(val > 0, val, torch.ones_like(val))
    return torch.where(val / (h * w) < 0.75, torch.full_like(dist, 1000.0),
                       dist)


def frame_distance(poses, disps, intr, ii, jj, beta):
    """The mean flow between frames ii and jj, both ways: a blend of the
    full warp (``beta``) and the translation-only warp; 1000 where fewer
    than 3/4 of the pixels land in front of the camera."""
    return 0.5 * (_directed_distance(poses, disps, intr, ii, jj, beta)
                  + _directed_distance(poses, disps, intr, jj, ii, beta))
