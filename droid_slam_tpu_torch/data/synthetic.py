"""Procedural multi-view RGB-D scenes with exact geometry.

A numpy copy of ``droid_slam_tpu/data/synthetic.py``: camera trajectories
inside a textured box, rendered by exact per-pixel ray casting, for training
and tests without a downloaded dataset. Every sample ships photo-consistent
images, exact ground-truth poses and exact inverse depth, with the tuple
contract of the TartanAir reader (images, poses [c2w t+q], disparities,
intrinsics).

Scene model: the camera moves inside an axis-aligned box of half-size S.
Each pixel ray exits through exactly one face; depth is the exact ray
parameter (z_cam = s for rays cast with unit z in camera coords) and color
is a 3-octave procedural value noise evaluated at the 3-D exit point, so the
texture is view-consistent by construction (no texture seams, no occlusion
special cases). Clips are cached in-process.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# procedural texture: 3-octave value noise on the 3-D exit points
# ---------------------------------------------------------------------------

def _hash3(ix, iy, iz, seed):
    """Deterministic pseudo-random in [0,1) from integer lattice coords."""
    h = (ix * 374761393 + iy * 668265263 + iz * 2147483647 + seed
         * 981039) & 0x7FFFFFFF
    h = (h ^ (h >> 13)) * 1274126177 & 0x7FFFFFFF
    return ((h ^ (h >> 16)) & 0xFFFFFF).astype(np.float32) / float(0xFFFFFF)


def _value_noise3(p, seed):
    """Trilinear value noise at 3-D points p [..., 3] -> [0,1)."""
    pf = np.floor(p)
    ix, iy, iz = (pf[..., k].astype(np.int64) for k in range(3))
    fx, fy, fz = (p[..., k] - pf[..., k] for k in range(3))
    # smoothstep fade
    fx = fx * fx * (3 - 2 * fx)
    fy = fy * fy * (3 - 2 * fy)
    fz = fz * fz * (3 - 2 * fz)

    def corner(dx, dy, dz):
        return _hash3(ix + dx, iy + dy, iz + dz, seed)

    c000, c100 = corner(0, 0, 0), corner(1, 0, 0)
    c010, c110 = corner(0, 1, 0), corner(1, 1, 0)
    c001, c101 = corner(0, 0, 1), corner(1, 0, 1)
    c011, c111 = corner(0, 1, 1), corner(1, 1, 1)
    x00 = c000 + (c100 - c000) * fx
    x10 = c010 + (c110 - c010) * fx
    x01 = c001 + (c101 - c001) * fx
    x11 = c011 + (c111 - c011) * fx
    y0 = x00 + (x10 - x00) * fy
    y1 = x01 + (x11 - x01) * fy
    return y0 + (y1 - y0) * fz


def _texture(points, seed):
    """View-consistent RGB texture in [0,255] at world points [...,3]."""
    out = np.empty(points.shape[:-1] + (3,), np.float32)
    for c in range(3):
        v = (0.55 * _value_noise3(points * 3.1, seed * 7 + c)
             + 0.3 * _value_noise3(points * 9.7, seed * 13 + 100 + c)
             + 0.15 * _value_noise3(points * 31.3, seed * 29 + 200 + c))
        out[..., c] = v
    return np.clip(out * 255.0, 0, 255)


# ---------------------------------------------------------------------------
# exact ray-cast rendering of the box interior
# ---------------------------------------------------------------------------

def render_view(R_c2w, t_c2w, intrinsics, image_size, box_half=2.0, seed=0):
    """Render one pinhole view from inside the box.

    R_c2w [3,3], t_c2w [3]; intrinsics [fx,fy,cx,cy]; camera convention
    x-right / y-down / z-forward (matches geom/projective.py). Returns
    (image [H,W,3] float32 BGR in [0,255], depth [H,W] float32).
    """
    H, W = image_size
    fx, fy, cx, cy = intrinsics
    u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    # camera-frame ray directions with unit z: depth == ray parameter s
    dc = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], axis=-1)
    dirs = dc @ R_c2w.T                       # [H,W,3] world
    o = t_c2w.astype(np.float32)

    # exit parameter through the axis-aligned box |x_k| = box_half:
    # per axis the positive-s face is box_half*sign(dir_k)
    with np.errstate(divide="ignore", invalid="ignore"):
        s_axis = (np.copysign(box_half, dirs) - o) / dirs  # [H,W,3]
    s_axis = np.where(np.abs(dirs) < 1e-9, np.inf, s_axis)
    s = np.min(s_axis, axis=-1)               # camera inside => all finite>0

    pts = o + dirs * s[..., None]
    img_rgb = _texture(pts, seed)
    return img_rgb[..., ::-1].copy(), s.astype(np.float32)


def _quat_from_mat(R):
    """Rotation matrix -> quaternion [x,y,z,w] (Shepperd's method)."""
    m = R
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w], np.float32)
    return q / np.linalg.norm(q)


def _axis_angle_mat(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / (np.linalg.norm(axis) + 1e-12)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(angle) * K
            + (1 - np.cos(angle)) * (K @ K)).astype(np.float32)


def random_trajectory(n_frames, rng, box_half=2.0, step=0.22, rot_step=0.05):
    """Smooth random camera walk inside the box.

    Returns (Rs [N,3,3], ts [N,3]) camera-to-world. Step sizes default to
    ~20-60 px of mean flow at fx=320 and box scale 2 — inside the training
    covisibility band [fmin, fmax] = [8, 96] px (train.py:158-159)."""
    # random initial orientation (uniform via QR)
    A = rng.normal(size=(3, 3))
    Q, _ = np.linalg.qr(A)
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    R = Q.astype(np.float32)
    t = rng.uniform(-0.4, 0.4, size=3).astype(np.float32) * box_half

    Rs, ts = [R], [t.copy()]
    vel = rng.normal(size=3)
    vel *= step / (np.linalg.norm(vel) + 1e-9)
    lim = 0.6 * box_half
    for _ in range(n_frames - 1):
        vel = 0.7 * vel + 0.3 * rng.normal(size=3) * step
        # keep the walk moving (flow must stay inside the covisibility band)
        vel *= step / (np.linalg.norm(vel) + 1e-9)
        t = t + vel.astype(np.float32)
        # reflect at the inner safety boundary instead of stalling against it
        for k in range(3):
            if abs(t[k]) > lim:
                t[k] = np.clip(t[k], -lim, lim)
                vel[k] = -vel[k]
        dR = _axis_angle_mat(rng.normal(size=3),
                             abs(rng.normal()) * rot_step)
        R = (R @ dR).astype(np.float32)
        Rs.append(R)
        ts.append(t.copy())
    return np.stack(Rs), np.stack(ts)


def poses_c2w_from_mats(Rs, ts):
    """[N,3,3],[N,3] -> [N,7] camera-to-world [t, q]."""
    return np.stack([np.concatenate([t, _quat_from_mat(R)])
                     for R, t in zip(Rs, ts)]).astype(np.float32)


# ---------------------------------------------------------------------------
# dataset (training) + stream (evaluation)
# ---------------------------------------------------------------------------

class SyntheticBox:
    """Training dataset: each item is a rendered clip
    (images [N,H,W,3] f32 BGR, poses [N,7] c2w, disps [N,H,W], intr [N,4]).

    Same tuple contract as data/tartan.py::TartanAir.__getitem__, so
    train.py's collate/frame-graph path works unchanged. Clips are rendered
    once and cached (the pose/texture randomization lives in the clip seed;
    per-step variation comes from the frame-graph randomization and the
    restart mechanism in the trainer)."""

    def __init__(self, n_clips=64, n_frames=7, image_size=(384, 512),
                 seed=0, box_half=2.0, step=0.22, rot_step=0.05):
        self.n_clips = n_clips
        self.n_frames = n_frames
        self.image_size = image_size
        self.seed = seed
        self.box_half = box_half
        # camera-motion difficulty (fed to random_trajectory): larger
        # steps/rotations give larger flows and harder covisibility
        self.step = step
        self.rot_step = rot_step
        H, W = image_size
        self.intrinsics = np.array([0.8 * W, 0.8 * W, W / 2, H / 2],
                                   np.float32)
        self._cache = {}

    def __len__(self):
        return self.n_clips

    def render_clip(self, index):
        rng = np.random.default_rng(self.seed * 100003 + index)
        scene_seed = int(rng.integers(1, 2 ** 20))
        Rs, ts = random_trajectory(self.n_frames, rng, self.box_half,
                                   step=self.step, rot_step=self.rot_step)
        images, depths = [], []
        for R, t in zip(Rs, ts):
            img, depth = render_view(R, t, self.intrinsics, self.image_size,
                                     self.box_half, scene_seed)
            images.append(img)
            depths.append(depth)
        images = np.stack(images)
        disps = 1.0 / np.stack(depths)
        poses = poses_c2w_from_mats(Rs, ts)
        N = len(images)
        intr = np.broadcast_to(self.intrinsics, (N, 4)).copy()
        return images, poses, disps, intr

    def __getitem__(self, index):
        index = int(index) % self.n_clips
        if index not in self._cache:
            self._cache[index] = self.render_clip(index)
        images, poses, disps, intr = self._cache[index]
        return images.copy(), poses.copy(), disps.copy(), intr.copy()


STEREO_BASELINE = 0.1  # rectified baseline, matches the fixed stereo edge
                       # transform Gij=[-0.1,0,0,id] (geom/projective.py:31,
                       # reference projective_ops.py:176-178)


def synthetic_stream(n_frames=120, image_size=(320, 512), seed=7,
                     box_half=2.0, step=0.10, rot_step=0.03,
                     stereo=False, with_depth=False, workers=1):
    """Evaluation stream: yields (t, image [C,H,W,3] uint8 BGR, intr [4]),
    C=2 with ``stereo`` (right view rendered at the rectified +0.1 x-axis
    baseline so the (i,i) stereo edges' fixed Gij is exact); with
    ``with_depth`` yields (t, image, depth [H,W] float32, intr) — z-depth
    of the left view, the input demo.py feeds for RGB-D streams. With
    ``workers`` > 1 the frames are rendered ahead by that many threads
    (numpy releases the GIL in the renderer's array ops); they are the
    same frames, in the same order.

    Use `synthetic_groundtruth` with the same arguments for the GT
    trajectory. Mirrors the image_stream generators in
    evaluation_scripts/test_*.py."""
    H, W = image_size
    rng = np.random.default_rng(seed)
    scene_seed = int(rng.integers(1, 2 ** 20))
    Rs, ts = random_trajectory(n_frames, rng, box_half, step, rot_step)
    intr = np.array([0.8 * W, 0.8 * W, W / 2, H / 2], np.float32)

    def frame(k):
        R, t = Rs[k], ts[k]
        img, depth = render_view(R, t, intr, (H, W), box_half, scene_seed)
        views = [img.astype(np.uint8)]
        if stereo:
            t_r = t + R @ np.array([STEREO_BASELINE, 0, 0], np.float32)
            img_r, _ = render_view(R, t_r, intr, (H, W), box_half,
                                   scene_seed)
            views.append(img_r.astype(np.uint8))
        stack = np.stack(views)
        if with_depth:
            return k, stack, depth.copy(), intr.copy()
        return k, stack, intr.copy()

    if workers > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(workers) as pool:
            yield from pool.map(frame, range(len(Rs)))
    else:
        for k in range(len(Rs)):
            yield frame(k)


def synthetic_groundtruth(n_frames=120, image_size=(320, 512), seed=7,
                          box_half=2.0, step=0.10, rot_step=0.03):
    """Ground-truth camera-to-world poses [N,7] for `synthetic_stream`."""
    rng = np.random.default_rng(seed)
    rng.integers(1, 2 ** 20)  # consume the scene seed draw
    Rs, ts = random_trajectory(n_frames, rng, box_half, step, rot_step)
    return poses_c2w_from_mats(Rs, ts)
