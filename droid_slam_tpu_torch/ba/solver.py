"""Cholesky solve of the damped BA normal equations.

Counterpart of ``droid_slam_tpu/ba/solver.py``: f32 Cholesky plus one step
of iterative refinement; a system whose factorization fails gets a zero
step, not an exception. No host synchronization.
"""

from __future__ import annotations

import torch


def solve_psd(H: torch.Tensor, b: torch.Tensor, refine_steps: int = 1):
    """Solve H x = b for symmetric positive definite H [n,n], b [n]."""
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    # the probe stays outside the gradient (droid_slam_tpu/ba/solver.py:
    # 38-45): the differentiable factorization below only ever sees an SPD
    # matrix, so an indefinite system gives a zero step and finite grads
    L_probe, info = torch.linalg.cholesky_ex(H.detach())
    ok = (info == 0) & torch.isfinite(L_probe).all()
    L, _ = torch.linalg.cholesky_ex(torch.where(ok, H, eye))

    def chosolve(rhs):
        return torch.cholesky_solve(rhs[:, None], L)[:, 0]

    x = chosolve(b)
    for _ in range(refine_steps):
        x = x + chosolve(b - H @ x)
    return torch.where(ok, x, torch.zeros_like(x))
