"""Absolute trajectory error (ATE) after a Umeyama alignment with scale,
and the relative pose error (RPE).

The port's own copy of ``droid_slam_tpu/eval/ate.py`` (numpy:
``umeyama_alignment``, ``ate_rmse``, ``associate_timestamps``,
``evaluate_ate``, ``rpe_pairs``, ``rpe``), so that nothing of the JAX
package is imported.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform aligning x -> y.

    x, y: [3, n]. Returns (R [3,3], t [3], s scalar) minimizing
    ||y - (s R x + t)||^2 (Umeyama 1991; evaluate_ate_scale.py:align).
    """
    mx = x.mean(axis=1, keepdims=True)
    my = y.mean(axis=1, keepdims=True)
    xc, yc = x - mx, y - my
    cov = yc @ xc.T / x.shape[1]
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_x = (xc ** 2).sum() / x.shape[1]
    s = float(np.trace(np.diag(d) @ S) / var_x) if with_scale else 1.0
    t = (my - s * R @ mx)[:, 0]
    return R, t, s


def ate_rmse(est_xyz: np.ndarray, ref_xyz: np.ndarray, scale: bool = True):
    """ATE RMSE after (scaled) rigid alignment. est/ref: [n,3].
    Returns (rmse, per-frame errors, s)."""
    R, t, s = umeyama_alignment(est_xyz.T, ref_xyz.T, with_scale=scale)
    aligned = (s * R @ est_xyz.T + t[:, None]).T
    err = np.linalg.norm(aligned - ref_xyz, axis=1)
    return float(np.sqrt(np.mean(err ** 2))), err, s


def associate_timestamps(t_est, t_ref, max_dt=0.02):
    """Greedy nearest-timestamp association (rgbd benchmark convention)."""
    t_est = np.asarray(t_est, np.float64)
    t_ref = np.asarray(t_ref, np.float64)
    ii, jj = [], []
    used = set()
    for i, t in enumerate(t_est):
        j = int(np.argmin(np.abs(t_ref - t)))
        if abs(t_ref[j] - t) < max_dt and j not in used:
            ii.append(i); jj.append(j); used.add(j)
    return np.asarray(ii), np.asarray(jj)


def evaluate_ate(est_traj, ref_traj, t_est=None, t_ref=None, scale=True,
                 max_dt=0.02):
    """est/ref: [n,>=3] with xyz in the first 3 columns; optional timestamp
    association. Returns dict with ate_rmse, scale, n_matches."""
    est_xyz = np.asarray(est_traj)[:, :3]
    ref_xyz = np.asarray(ref_traj)[:, :3]
    if t_est is not None and t_ref is not None:
        ii, jj = associate_timestamps(t_est, t_ref, max_dt)
        est_xyz, ref_xyz = est_xyz[ii], ref_xyz[jj]
    else:
        n = min(len(est_xyz), len(ref_xyz))
        est_xyz, ref_xyz = est_xyz[:n], ref_xyz[:n]
    if not np.isfinite(est_xyz).all():
        # a divergent track (e.g. random-init weights) is a valid *result*:
        # score it inf instead of crashing the Umeyama SVD
        return {"ate_rmse": float("inf"), "scale": 1.0,
                "n_matches": len(est_xyz),
                "errors": np.full(len(est_xyz), np.inf)}
    rmse, err, s = ate_rmse(est_xyz, ref_xyz, scale=scale)
    return {"ate_rmse": rmse, "scale": s, "n_matches": len(est_xyz),
            "errors": err}


def _pose_matrices(poses):
    """[n,7] ([t,q]) -> [n,4,4] homogeneous matrices."""
    from scipy.spatial.transform import Rotation

    poses = np.asarray(poses, np.float64)
    out = np.tile(np.eye(4), (len(poses), 1, 1))
    out[:, :3, :3] = Rotation.from_quat(poses[:, 3:7]).as_matrix()
    out[:, :3, 3] = poses[:, :3]
    return out


def rpe_pairs(est_poses, ref_poses, delta: int = 1):
    """Per-pair relative pose errors, TUM-benchmark convention
    (tartanair_tools evaluate_rpe.py:123-130): for each frame pair (i, i+d),
    error44 = (est_rel)^-1 · ref_rel with x_rel = x[i+d]^-1 · x[i]; returns
    (trans_err [m], rot_err [rad]) arrays."""
    est = _pose_matrices(est_poses)
    ref = _pose_matrices(ref_poses)
    n = min(len(est), len(ref)) - delta
    d_est = np.linalg.inv(est[delta:n + delta]) @ est[:n]
    d_ref = np.linalg.inv(ref[delta:n + delta]) @ ref[:n]
    err = np.linalg.inv(d_est) @ d_ref
    t_err = np.linalg.norm(err[:, :3, 3], axis=-1)
    tr = np.clip((np.trace(err[:, :3, :3], axis1=1, axis2=2) - 1) / 2, -1, 1)
    return t_err, np.arccos(tr)


def rpe(est_poses, ref_poses, delta: int = 1):
    """Aggregate relative pose error. est/ref: [n,7] pose arrays ([t,q],
    c2w). Returns (trans_rmse, rot_rmse radians)."""
    t_err, r_err = rpe_pairs(est_poses, ref_poses, delta)
    return (float(np.sqrt(np.mean(t_err ** 2))),
            float(np.sqrt(np.mean(r_err ** 2))))
