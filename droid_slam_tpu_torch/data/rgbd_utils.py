"""Dataset utilities: TUM-format loading, timestamp association, and the
all-pairs flow-distance matrix of a scene's frames.

Counterpart of ``droid_slam_tpu/data/rgbd_utils.py``. The flow matrix runs
the port's geometry one row at a time on the device it is given; the
loaders call it on the CPU, so that it never queues behind a training step
on the card.
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch

from ..geom import projective as pops
from ..lie import se3


def parse_list(filepath, skiprows=0):
    return np.loadtxt(filepath, delimiter=" ", dtype=np.str_,
                      skiprows=skiprows)


def _nearest(ref, query):
    """For each query timestamp, the index of the closest ref timestamp and
    the residual |ref[j] - query|."""
    ref = np.asarray(ref, np.float64)
    query = np.asarray(query, np.float64)
    j = np.abs(query[:, None] - ref[None, :]).argmin(axis=1)
    return j, np.abs(ref[j] - query)


def associate_frames(tstamp_image, tstamp_depth, tstamp_pose=None,
                     max_dt=1.0):
    """Nearest-timestamp matching of image frames to depth (and optionally
    pose) streams; frames without a match within max_dt are dropped."""
    jd, err_d = _nearest(tstamp_depth, tstamp_image)
    if tstamp_pose is None:
        keep = np.nonzero(err_d < max_dt)[0]
        return [(int(i), int(jd[i])) for i in keep]
    jp, err_p = _nearest(tstamp_pose, tstamp_image)
    keep = np.nonzero((err_d < max_dt) & (err_p < max_dt))[0]
    return [(int(i), int(jd[i]), int(jp[i])) for i in keep]


def _first_existing(datapath, names):
    for n in names:
        p = osp.join(datapath, n)
        if osp.isfile(p):
            return p
    return None


def loadtum(datapath, frame_rate=-1):
    """A TUM-format RGB-D sequence directory as aligned per-frame lists
    (images, depths, poses, intrinsics, tstamps), every 5th associated
    frame kept."""
    pose_file = _first_existing(datapath, ("groundtruth.txt", "pose.txt"))
    if pose_file is None:
        return None, None, None, None, None

    rgb_tab = parse_list(osp.join(datapath, "rgb.txt"))
    dep_tab = parse_list(osp.join(datapath, "depth.txt"))
    pose_tab = parse_list(pose_file, skiprows=1)

    t_img = rgb_tab[:, 0].astype(np.float64)
    t_dep = dep_tab[:, 0].astype(np.float64)
    t_pose = pose_tab[:, 0].astype(np.float64)

    assoc = np.array(associate_frames(t_img, t_dep, t_pose), np.int64)
    assoc = assoc[::5]
    if assoc.size == 0:
        return [], [], [], [], []
    i_img, i_dep, i_pose = assoc.T

    calib = _first_existing(datapath, ("calibration.txt",))
    if calib is not None:
        k = np.loadtxt(calib, delimiter=" ").astype(np.float64)
        intrinsics = [k] * len(assoc)
    else:
        intrinsics = []

    images = [osp.join(datapath, str(f)) for f in rgb_tab[i_img, 1]]
    depths = [osp.join(datapath, str(f)) for f in dep_tab[i_dep, 1]]
    poses = list(pose_tab[i_pose, 1:].astype(np.float64))
    tstamps = list(t_img[i_img])
    return images, depths, poses, intrinsics, tstamps


def all_pairs_distance_matrix(poses, beta=2.5):
    """SE3 geodesic distance between all pairs of poses, translations
    scaled by beta."""
    poses = np.array(poses, dtype=np.float32)
    poses[:, :3] *= beta
    P = torch.from_numpy(poses)
    rel = se3.mul(se3.inv(P[:, None, :]), P[None, :, :])
    return torch.linalg.norm(se3.log(rel), dim=-1).numpy()


def pose_matrix_to_quaternion(pose):
    from scipy.spatial.transform import Rotation
    q = Rotation.from_matrix(pose[:3, :3]).as_quat()
    return np.concatenate([pose[:3, 3], q], axis=0)


# per-pixel flow saturates at MAX_FLOW px, and a pair counts as covisible
# only where at least MIN_COVIS of its pixels reproject validly (both
# directions pooled); other pairs score inf
MAX_FLOW = 100.0
MIN_COVIS = 0.7


def _flow_row(poses_w2c, disps, intr, i):
    """Symmetric mean-flow distances from frame i to every frame [N]."""
    jj = torch.arange(poses_w2c.shape[0], device=disps.device)
    ii = torch.full_like(jj, i)
    num = torch.zeros(jj.shape, dtype=disps.dtype, device=disps.device)
    den = torch.zeros_like(num)
    for a, b in ((ii, jj), (jj, ii)):  # bidirectional, pooled
        flow, val = pops.induced_flow(poses_w2c, disps, intr, a, b)
        mag = torch.linalg.norm(flow, dim=-1).clamp(max=MAX_FLOW)
        val = val.reshape(val.shape[0], -1)
        num = num + (mag.reshape(mag.shape[0], -1) * val).sum(-1)
        den = den + val.sum(-1)
    covis = den / (2.0 * disps.shape[-2] * disps.shape[-1])
    mean = num / den.clamp(min=1e-8)
    return torch.where(covis < MIN_COVIS, torch.full_like(mean, np.inf),
                       mean)


@torch.no_grad()
def compute_distance_matrix_flow(poses, disps, intrinsics, device="cpu"):
    """Mean induced-flow magnitude between all frame pairs [N,N] (numpy).
    poses are camera-to-world [N,7], inverted here; disps [N,h,w] and
    intrinsics [N,4] at one scale. One row at a time: peak memory O(N*h*w)."""
    poses_w2c = se3.inv(torch.as_tensor(np.array(poses, np.float32),
                                        device=device))
    disps = torch.as_tensor(np.array(disps, np.float32), device=device)
    intr = torch.as_tensor(np.array(intrinsics, np.float32), device=device)
    rows = [_flow_row(poses_w2c, disps, intr, i)
            for i in range(poses_w2c.shape[0])]
    return torch.stack(rows).cpu().numpy()
