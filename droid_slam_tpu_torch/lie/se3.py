"""SE(3) on quaternions, as plain functions on tensors.

Counterpart of ``droid_slam_tpu/lie/se3.py``. Poses are 7 floats
``[tx, ty, tz, qx, qy, qz, qw]``; all ops broadcast over leading dims.
exp/log use the ``[tau, phi]`` ordering (translation first);
``retr(g, xi) = exp(xi) * g`` is the left retraction.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    base = torch.tensor([0, 0, 0, 0, 0, 0, 1], dtype=dtype, device=device)
    return base.expand(tuple(shape) + (7,)).clone()


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def quat_mul(q1, q2):
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
        w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_inv(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_rotate(q, v):
    """R(q) v in the two-cross-product form."""
    qv, w = q[..., :3], q[..., 3:4]
    qv, v = torch.broadcast_tensors(qv, v)
    uv = 2.0 * _cross(qv, v)
    return v + w * uv + _cross(qv, uv)


def quat_to_matrix(q):
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def mul(a, b):
    t = quat_rotate(a[..., 3:7], b[..., :3]) + a[..., :3]
    q = quat_mul(a[..., 3:7], b[..., 3:7])
    return torch.cat([t, q], dim=-1)


def inv(g):
    qi = quat_inv(g[..., 3:7])
    return torch.cat([-quat_rotate(qi, g[..., :3]), qi], dim=-1)


def relative(gi, gj):
    """g_ij = g_j * g_i^-1 (maps frame-i points to frame j)."""
    return mul(gj, inv(gi))


def act(g, X):
    """Homogeneous points X[..., 4]: Y[:3] = R X[:3] + w t, Y[3] = w."""
    y = quat_rotate(g[..., 3:7], X[..., :3]) + X[..., 3:4] * g[..., :3]
    return torch.cat([y, X[..., 3:4].expand(y.shape[:-1] + (1,))], dim=-1)


def act3(g, x):
    """3-vectors x[..., 3]: R x + t."""
    return quat_rotate(g[..., 3:7], x) + g[..., :3]


def so3_exp(phi):
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    theta = torch.sqrt(theta_sq)
    theta_p4 = theta_sq * theta_sq
    small = theta_sq < 1e-8
    safe_theta = torch.where(small, torch.ones_like(theta), theta)
    imag = torch.where(small, 0.5 - theta_sq / 48.0 + theta_p4 / 3840.0,
                       torch.sin(0.5 * safe_theta) / safe_theta)
    real = torch.where(small, 1.0 - theta_sq / 8.0 + theta_p4 / 384.0,
                       torch.cos(0.5 * safe_theta))
    return torch.cat([imag * phi, real], dim=-1)


def so3_log(q):
    qv, qw = q[..., :3], q[..., 3:4]
    sign = torch.where(qw < 0, -torch.ones_like(qw), torch.ones_like(qw))
    qv, qw = qv * sign, qw * sign
    s_sq = (qv * qv).sum(-1, keepdim=True)
    s = torch.sqrt(s_sq)
    small = s_sq < 1e-12
    safe_s = torch.where(small, torch.ones_like(s), s)
    theta = 2.0 * torch.atan2(s, qw)
    safe_qw = torch.where(qw.abs() < _EPS, torch.ones_like(qw), qw)
    k = torch.where(
        small, 2.0 / safe_qw * (1.0 - s_sq / (3.0 * safe_qw * safe_qw)),
        theta / safe_s)
    return k * qv


def exp(xi):
    """se(3) tangent [tau, phi] -> group element."""
    tau, phi = xi[..., :3], xi[..., 3:6]
    q = so3_exp(phi)
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    small = theta_sq < 1e-8
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    safe_theta = torch.sqrt(safe_sq)
    a = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(safe_theta)) / safe_sq)
    b = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (safe_theta - torch.sin(safe_theta))
                    / (safe_theta * safe_sq))
    phi_x_tau = _cross(phi, tau)
    t = tau + a * phi_x_tau + b * _cross(phi, phi_x_tau)
    return torch.cat([t, q], dim=-1)


def log(g):
    t = g[..., :3]
    phi = so3_log(g[..., 3:7])
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    small = theta_sq < 1e-8
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    half = 0.5 * torch.sqrt(safe_sq)
    c = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                    (1.0 - half * torch.cos(half) / torch.sin(half))
                    / safe_sq)
    phi_x_t = _cross(phi, t)
    tau = t - 0.5 * phi_x_t + c * _cross(phi, phi_x_t)
    return torch.cat([tau, phi], dim=-1)


def retr(g, xi):
    """Left retraction exp(xi) * g."""
    return mul(exp(xi), g)


def adjT(g, a):
    """Ad(g)^T a for covectors a[..., 6] = [a_v, a_w]."""
    qinv = quat_inv(g[..., 3:7])
    av, aw, t = a[..., :3], a[..., 3:6], g[..., :3]
    out_v = quat_rotate(qinv, av)
    out_w = quat_rotate(qinv, aw) + quat_rotate(
        qinv, _cross(av, t.expand_as(av)))
    return torch.cat([out_v, out_w], dim=-1)


def adj_matrix(g):
    """Ad(g) [..., 6, 6] = [[R, [t]x R], [0, R]]; adjT(g, a) == a @ Ad(g)."""
    R = quat_to_matrix(g[..., 3:7])
    tx, ty, tz = g[..., 0], g[..., 1], g[..., 2]
    o = torch.zeros_like(tx)
    S = torch.stack([o, -tz, ty, tz, o, -tx, -ty, tx, o],
                    dim=-1).reshape(tx.shape + (3, 3))
    top = torch.cat([R, S @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def normalize(g):
    q = g[..., 3:7]
    q = q / q.norm(dim=-1, keepdim=True).clamp(min=_EPS)
    return torch.cat([g[..., :3], q], dim=-1)
