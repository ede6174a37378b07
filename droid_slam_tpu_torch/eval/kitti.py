"""KITTI odometry metrics: translation (fraction of the path length) and
rotation (rad per metre) errors over fixed path lengths.

The port's own numpy copy of ``droid_slam_tpu/eval/kitti.py``
(``kitti_sequence_errors``, ``kitti_metrics``), so that nothing of the JAX
package is imported.
"""

from __future__ import annotations

import numpy as np

LENGTHS = (100, 200, 300, 400, 500, 600, 700, 800)


def _pose_mats(traj):
    """[n,7] ([t,q]) -> [n,4,4] c2w matrices."""
    from scipy.spatial.transform import Rotation

    out = np.tile(np.eye(4), (len(traj), 1, 1))
    out[:, :3, :3] = Rotation.from_quat(traj[:, 3:7]).as_matrix()
    out[:, :3, 3] = traj[:, :3]
    return out


def _trajectory_distances(poses):
    d = [0.0]
    for i in range(1, len(poses)):
        d.append(d[-1] + np.linalg.norm(poses[i, :3, 3] - poses[i - 1, :3, 3]))
    return np.asarray(d)


def _last_frame_from_len(dist, first, length):
    ix = np.where(dist > dist[first] + length)[0]
    return int(ix[0]) if len(ix) else -1


def kitti_sequence_errors(gt_traj, est_traj, step: int = 10,
                          lengths=LENGTHS):
    """Per-segment normalized errors: list of (first_frame, r_err/length
    [rad/m], t_err/length [fraction], length) — the quantity
    evaluate_kitti.py:45-84 accumulates."""
    gt = _pose_mats(np.asarray(gt_traj))
    est = _pose_mats(np.asarray(est_traj))
    dist = _trajectory_distances(gt)

    segments = []
    for first in range(0, len(gt), step):
        for length in lengths:
            last = _last_frame_from_len(dist, first, length)
            if last < 0:
                continue
            dgt = np.linalg.inv(gt[first]) @ gt[last]
            dest = np.linalg.inv(est[first]) @ est[last]
            err = np.linalg.inv(dest) @ dgt
            t_err = np.linalg.norm(err[:3, 3])
            ang = np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)
            segments.append((first, np.arccos(ang) / length, t_err / length,
                             length))
    return segments


def kitti_metrics(gt_traj, est_traj, step: int = 10, lengths=LENGTHS):
    """Returns (t_rel, r_rel): average translation error (fraction) and
    rotation error (rad/m) over the standard segment lengths."""
    segments = kitti_sequence_errors(gt_traj, est_traj, step, lengths)
    if not segments:
        return 0.0, 0.0
    r_errs = [s[1] for s in segments]
    t_errs = [s[2] for s in segments]
    return float(np.mean(t_errs)), float(np.mean(r_errs))
