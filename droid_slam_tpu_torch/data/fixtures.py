"""Write procedural synthetic scenes into real datasets' on-disk layouts.

A copy of ``droid_slam_tpu/data/fixtures.py``: the box scenes of
``data/synthetic.py`` rendered into the directory structures that the
readers and evaluation scripts consume, so that their parsing, association
and ground-truth paths run without the real corpora:

  EuRoC  : mav0/cam{0,1}/data/<ns>.png + a TUM-style GT file
  TUM    : rgb/<t>.png + groundtruth.txt
  ETH3D  : rgb/ + depth/(uint16 /5000) + rgb.txt + calibration.txt
           + groundtruth.txt
  TartanAir : <env>/<env>/Easy/P00k/{image_left, depth_left, pose_left.txt}

Accuracy on these fixtures is not meaningful (the cameras and distortion
models do not match the synthetic pinhole render); they prove the plumbing.
"""

from __future__ import annotations

import os

import numpy as np

from .synthetic import poses_c2w_from_mats, random_trajectory, render_view


def _trajectory(n_frames, seed, step=0.08, rot_step=0.02):
    rng = np.random.default_rng(seed)
    scene_seed = int(rng.integers(1, 2 ** 20))
    Rs, ts = random_trajectory(n_frames, rng, step=step, rot_step=rot_step)
    return Rs, ts, scene_seed


def write_euroc_fixture(root, n_frames=20, seed=3, image_size=(480, 752),
                        stereo=False):
    """EuRoC MAV layout: mav0/cam0/data/<ns>.png (+ cam1 for stereo) and a
    TUM-style GT file (returned path) in the vendored
    data/euroc_groundtruth format. Rendered with the rectified pinhole
    intrinsics (P_l of test_euroc.py) so the stream's rectification maps
    stay near-identity."""
    import cv2

    H, W = image_size
    # rectified projection of the reference's stereo maps (stream.py P_l),
    # scaled to the render resolution
    intr = np.array([435.2046959714599 * W / 752.0,
                     435.2046959714599 * H / 480.0,
                     367.4517211914062 * W / 752.0,
                     252.2008514404297 * H / 480.0], np.float32)
    Rs, ts, scene_seed = _trajectory(n_frames, seed)
    cam0 = os.path.join(root, "mav0", "cam0", "data")
    os.makedirs(cam0, exist_ok=True)
    if stereo:
        cam1 = os.path.join(root, "mav0", "cam1", "data")
        os.makedirs(cam1, exist_ok=True)
        baseline = 47.90639384423901 / 435.2046959714599  # m, from P_r tx

    t0_ns = 1403636580863555584  # EuRoC-era ns epoch, 20 Hz
    gt_rows = []
    for k, (R, t) in enumerate(zip(Rs, ts)):
        ns = t0_ns + k * 50_000_000
        img, _ = render_view(R, t, intr, (H, W), seed=scene_seed)
        cv2.imwrite(os.path.join(cam0, f"{ns}.png"), img.astype(np.uint8))
        if stereo:
            t_r = t + R @ np.array([baseline, 0, 0], np.float32)
            img_r, _ = render_view(R, t_r, intr, (H, W), seed=scene_seed)
            cv2.imwrite(os.path.join(cam1, f"{ns}.png"),
                        img_r.astype(np.uint8))
        q = poses_c2w_from_mats(R[None], t[None])[0, 3:]  # [x,y,z,w]
        gt_rows.append(f"{ns}.0000000000 {t[0]:.10f} {t[1]:.10f} "
                       f"{t[2]:.10f} {q[3]:.10f} {q[0]:.10f} {q[1]:.10f} "
                       f"{q[2]:.10f}")

    gt_path = os.path.join(root, "groundtruth.txt")
    with open(gt_path, "w") as f:
        f.write("#timestamp [ns] p_RS_R_x [m] p_RS_R_y [m] p_RS_R_z [m] "
                "q_RS_w [] q_RS_x [] q_RS_y [] q_RS_z []\n")
        f.write("\n".join(gt_rows) + "\n")
    return gt_path


def write_tum_fixture(root, n_frames=20, seed=4, image_size=(480, 640)):
    """TUM-RGBD layout: rgb/<t>.png + groundtruth.txt ('# ts x y z qx qy qz
    qw'). Rendered with the freiburg1 pinhole intrinsics (distortion-free;
    the stream's undistort becomes a mild warp)."""
    import cv2

    H, W = image_size
    intr = np.array([517.3 * W / 640.0, 516.5 * H / 480.0,
                     318.6 * W / 640.0, 255.3 * H / 480.0], np.float32)
    Rs, ts, scene_seed = _trajectory(n_frames, seed)
    rgb = os.path.join(root, "rgb")
    os.makedirs(rgb, exist_ok=True)

    t0 = 1305031102.175304  # freiburg1-era epoch, 15 Hz
    gt_rows = []
    for k, (R, t) in enumerate(zip(Rs, ts)):
        ts_s = t0 + k / 15.0
        img, _ = render_view(R, t, intr, (H, W), seed=scene_seed)
        cv2.imwrite(os.path.join(rgb, f"{ts_s:.6f}.png"),
                    img.astype(np.uint8))
        q = poses_c2w_from_mats(R[None], t[None])[0, 3:]
        gt_rows.append(f"{ts_s:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                       f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}")

    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        f.write("\n".join(gt_rows) + "\n")
    return root


def write_tartanair_fixture(root, n_scenes=2, n_frames=12, seed=6,
                            image_size=(480, 640)):
    """TartanAir layout: <env>/<env>/Easy/P00k/{image_left/*.png,
    depth_left/*.npy, pose_left.txt}. Poses are written in TartanAir's NED
    order with metre translations and depth npy in metres, i.e. the exact
    inverse of the reader's [1,2,0,4,5,3,6] remap + DEPTH_SCALE=5 division
    (data/tartan.py:72-91, reference tartan.py:43-70). Rendered with the
    dataset's fixed calibration (320,320,320,240 at 640x480) so geometry
    stays consistent with calib_read()."""
    import cv2

    H, W = image_size
    intr = np.array([320.0 * W / 640, 320.0 * H / 480,
                     320.0 * W / 640, 240.0 * H / 480], np.float32)
    for s in range(n_scenes):
        rng = np.random.default_rng(seed * 1009 + s)
        scene_seed = int(rng.integers(1, 2 ** 20))
        # default walk steps: ~20-60 px flow at fx=320, inside the
        # [fmin, fmax]=[8, 96] training covisibility band
        Rs, ts = random_trajectory(n_frames, rng)
        scene = os.path.join(root, "boxworld", "boxworld", "Easy",
                             f"P{s:03d}")
        os.makedirs(os.path.join(scene, "image_left"), exist_ok=True)
        os.makedirs(os.path.join(scene, "depth_left"), exist_ok=True)

        xyz = poses_c2w_from_mats(Rs, ts)          # [N,7] XYZ [t,q]
        ned = xyz[:, [2, 0, 1, 5, 3, 4, 6]].copy()  # inverse of reader remap
        ned[:, :3] *= 5.0                           # reader divides by 5
        np.savetxt(os.path.join(scene, "pose_left.txt"), ned, fmt="%.8f",
                   delimiter=" ")
        for k, (R, t) in enumerate(zip(Rs, ts)):
            img, depth = render_view(R, t, intr, (H, W), seed=scene_seed)
            cv2.imwrite(os.path.join(scene, "image_left",
                                     f"{k:06d}_left.png"),
                        img.astype(np.uint8))
            # reader: np.load(...)/5 -> metres; our depth is already the
            # scene-unit ray depth, store x5 so the round trip is exact
            np.save(os.path.join(scene, "depth_left", f"{k:06d}_left.npy"),
                    (depth * 5.0).astype(np.float32))
    return root


def write_eth3d_fixture(root, n_frames=16, seed=5, image_size=(240, 320)):
    """ETH3D-SLAM layout: rgb/*.png, depth/*.png (uint16, metres*5000),
    calibration.txt 'fx fy cx cy', rgb.txt 'ts path', groundtruth.txt
    '# ts x y z qx qy qz qw'. Depth is the exact render depth, so the RGB-D
    (depth-sensor) pipeline path gets geometrically consistent input."""
    import cv2

    H, W = image_size
    intr = np.array([0.8 * W, 0.8 * W, W / 2.0, H / 2.0], np.float32)
    Rs, ts, scene_seed = _trajectory(n_frames, seed)
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)

    np.savetxt(os.path.join(root, "calibration.txt"), intr[None], fmt="%.4f")
    rgb_rows, gt_rows = [], []
    for k, (R, t) in enumerate(zip(Rs, ts)):
        ts_s = 1000.0 + k / 10.0
        img, depth = render_view(R, t, intr, (H, W), seed=scene_seed)
        name = f"{ts_s:.6f}.png"
        cv2.imwrite(os.path.join(root, "rgb", name), img.astype(np.uint8))
        d16 = np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)
        cv2.imwrite(os.path.join(root, "depth", name), d16)
        rgb_rows.append(f"{ts_s:.6f} rgb/{name}")
        q = poses_c2w_from_mats(R[None], t[None])[0, 3:]
        gt_rows.append(f"{ts_s:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                       f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}")

    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("\n".join(rgb_rows) + "\n")
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        f.write("\n".join(gt_rows) + "\n")
    return root
