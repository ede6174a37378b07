"""Sim(3) on quaternions and a linear scale, as plain functions on tensors.

Counterpart of ``droid_slam_tpu/lie/sim3.py``. Storage: 8 floats
``[tx, ty, tz, qx, qy, qz, qw, s]``; the action on points is
``y = s R(q) x + t``; the tangent is 7-dim ``[tau, phi, sigma]`` with
``s = exp(sigma)``. The training losses read it (``train/losses.py``).
"""

from __future__ import annotations

import torch

from . import se3


def from_se3(g):
    return torch.cat([g, torch.ones_like(g[..., :1])], dim=-1)


def to_se3(g):
    return g[..., :7]


def identity(shape=(), dtype=torch.float32, device=None):
    base = torch.tensor([0, 0, 0, 0, 0, 0, 1, 1], dtype=dtype, device=device)
    return base.expand(tuple(shape) + (8,)).clone()


def scale(g, s):
    """Multiply the scale component by ``s`` (broadcasts)."""
    s = torch.as_tensor(s, dtype=g.dtype, device=g.device)
    if s.dim() < g.dim():
        s = s[..., None]
    return torch.cat([g[..., :7], g[..., 7:8] * s], dim=-1)


def mul(a, b):
    sa = a[..., 7:8]
    t = sa * se3.quat_rotate(a[..., 3:7], b[..., :3]) + a[..., :3]
    q = se3.quat_mul(a[..., 3:7], b[..., 3:7])
    return torch.cat([t, q, sa * b[..., 7:8]], dim=-1)


def inv(g):
    qi = se3.quat_inv(g[..., 3:7])
    si = 1.0 / g[..., 7:8]
    t = -si * se3.quat_rotate(qi, g[..., :3])
    return torch.cat([t, qi, si], dim=-1)


def act(g, X):
    """Homogeneous points X[..., 4]: Y[:3] = s R X[:3] + w t, Y[3] = w."""
    y = (g[..., 7:8] * se3.quat_rotate(g[..., 3:7], X[..., :3])
         + X[..., 3:4] * g[..., :3])
    return torch.cat([y, X[..., 3:4].expand(y.shape[:-1] + (1,))], dim=-1)


def _W_coeffs(theta_sq, sigma):
    """(A, B, C) of W = C I + A [phi]x + B [phi]x^2, t = W tau, with the
    small-sigma and small-theta limits taken where they apply."""
    theta = torch.sqrt(theta_sq)
    s = torch.exp(sigma)
    small_sig = sigma.abs() < 1e-5
    small_th = theta_sq < 1e-8
    safe_sig = torch.where(small_sig, torch.ones_like(sigma), sigma)
    safe_th = torch.where(small_th, torch.ones_like(theta), theta)
    safe_th_sq = safe_th * safe_th

    C = torch.where(small_sig, 1.0 + sigma / 2.0 + sigma * sigma / 6.0,
                    (s - 1.0) / safe_sig)

    cos_t, sin_t = torch.cos(safe_th), torch.sin(safe_th)
    denom = safe_sig * safe_sig + safe_th_sq
    a_gen = ((s * sin_t * safe_sig + (1.0 - s * cos_t) * safe_th)
             / (safe_th * denom))
    b_gen = (C - ((s * cos_t - 1.0) * safe_sig + s * sin_t * safe_th)
             / denom) / safe_th_sq
    a_sig0 = (1.0 - cos_t) / safe_th_sq
    b_sig0 = (safe_th - sin_t) / (safe_th * safe_th_sq)
    a_th0 = torch.where(small_sig, 0.5 + sigma / 6.0,
                        ((safe_sig - 1.0) * s + 1.0) / (safe_sig * safe_sig))
    b_th0 = torch.where(small_sig, 1.0 / 6.0 + sigma / 24.0,
                        (s * (safe_sig * safe_sig / 2.0 - safe_sig + 1.0)
                         - 1.0) / (safe_sig ** 3))

    A = torch.where(small_th, a_th0, torch.where(small_sig, a_sig0, a_gen))
    B = torch.where(small_th, b_th0, torch.where(small_sig, b_sig0, b_gen))
    return A, B, C


def exp(xi):
    """Tangent [tau, phi, sigma] -> Sim3."""
    tau, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6:7]
    q = se3.so3_exp(phi)
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    A, B, C = _W_coeffs(theta_sq, sigma)
    phi_x_tau = se3._cross(phi, tau)
    t = C * tau + A * phi_x_tau + B * se3._cross(phi, phi_x_tau)
    return torch.cat([t, q, torch.exp(sigma)], dim=-1)


def log(g):
    """Sim3 -> tangent [tau, phi, sigma]: tau = W^-1 t, with W^-1 = a I +
    b K + c K^2 (K = [phi]x, K^3 = -theta^2 K) solved in closed form."""
    phi = se3.so3_log(g[..., 3:7])
    sigma = torch.log(g[..., 7:8])
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    A, B, C = _W_coeffs(theta_sq, sigma)
    a = 1.0 / C
    m = C - theta_sq * B
    deno = m * m + theta_sq * A * A
    b = -a * A * C / deno
    c = a * (A * A - B * m) / deno
    t = g[..., :3]
    phi_x_t = se3._cross(phi, t)
    tau = a * t + b * phi_x_t + c * se3._cross(phi, phi_x_t)
    return torch.cat([tau, phi, sigma], dim=-1)
