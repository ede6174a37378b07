"""Evaluation image streams for EuRoC, TUM-RGBD and ETH3D.

The port's own copy of ``droid_slam_tpu/data/stream.py`` (numpy and cv2,
which is imported when a stream is read): stereo rectification maps for
EuRoC, undistortion and a crop for TUM, an area-preserving resize for ETH3D
RGB-D. Each yields (t, image(s) [H,W,3] or [2,H,W,3] BGR uint8,
intrinsics [4]) as numpy.
"""

from __future__ import annotations

import glob
import os

import numpy as np


def euroc_stream(datapath, image_size=(320, 512), stereo=False, stride=1):
    """test_euroc.py:27-82 (returns a list, reference behavior)."""
    import cv2

    K_l = np.array([458.654, 0.0, 367.215, 0.0, 457.296, 248.375,
                    0.0, 0.0, 1.0]).reshape(3, 3)
    d_l = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0])
    R_l = np.array([
        0.999966347530033, -0.001422739138722922, 0.008079580483432283,
        0.001365741834644127, 0.9999741760894847, 0.007055629199258132,
        -0.008089410156878961, -0.007044357138835809, 0.9999424675829176,
    ]).reshape(3, 3)
    P_l = np.array([435.2046959714599, 0, 367.4517211914062, 0,
                    0, 435.2046959714599, 252.2008514404297, 0,
                    0, 0, 1, 0]).reshape(3, 4)
    map_l = cv2.initUndistortRectifyMap(K_l, d_l, R_l, P_l[:3, :3],
                                        (752, 480), cv2.CV_32F)

    K_r = np.array([457.587, 0.0, 379.999, 0.0, 456.134, 255.238,
                    0.0, 0.0, 1]).reshape(3, 3)
    d_r = np.array([-0.28368365, 0.07451284, -0.00010473, -3.555907e-05, 0.0])
    R_r = np.array([
        0.9999633526194376, -0.003625811871560086, 0.007755443660172947,
        0.003680398547259526, 0.9999684752771629, -0.007035845251224894,
        -0.007729688520722713, 0.007064130529506649, 0.999945173484644,
    ]).reshape(3, 3)
    P_r = np.array([435.2046959714599, 0, 367.4517211914062,
                    -47.90639384423901, 0, 435.2046959714599,
                    252.2008514404297, 0, 0, 0, 1, 0]).reshape(3, 4)
    map_r = cv2.initUndistortRectifyMap(K_r, d_r, R_r, P_r[:3, :3],
                                        (752, 480), cv2.CV_32F)

    intrinsics_vec = np.array([435.2046959714599, 435.2046959714599,
                               367.4517211914062, 252.2008514404297])
    ht0, wd0 = 480, 752

    images_left = sorted(glob.glob(
        os.path.join(datapath, "mav0/cam0/data/*.png")))[::stride]
    images_right = [x.replace("cam0", "cam1") for x in images_left]

    data = []
    for t, (imgL, imgR) in enumerate(zip(images_left, images_right)):
        if stereo and not os.path.isfile(imgR):
            continue
        images = [cv2.remap(cv2.imread(imgL), map_l[0], map_l[1],
                            interpolation=cv2.INTER_LINEAR)]
        if stereo:
            images.append(cv2.remap(cv2.imread(imgR), map_r[0], map_r[1],
                                    interpolation=cv2.INTER_LINEAR))
        images = [cv2.resize(im, (image_size[1], image_size[0]))
                  for im in images]
        intr = intrinsics_vec.copy()
        intr[0] *= image_size[1] / wd0
        intr[1] *= image_size[0] / ht0
        intr[2] *= image_size[1] / wd0
        intr[3] *= image_size[0] / ht0
        img = np.stack(images) if stereo else images[0]
        data.append((stride * t, img, intr.astype(np.float32)))
    return data


def euroc_timestamps(datapath):
    images = sorted(glob.glob(os.path.join(datapath, "mav0/cam0/data/*.png")))
    return np.array([float(os.path.basename(x)[:-4]) for x in images])


def tum_stream(datapath, stride=2, image_size=(240, 320)):
    """test_tum.py:24-56: freiburg1 intrinsics, undistort, resize 352x256,
    crop 16/8 borders (the crop is fixed; image_size is the post-crop
    shape — the reference's hardcoded (240, 320))."""
    import cv2

    fx, fy, cx, cy = 517.3, 516.5, 318.6, 255.3
    K_l = np.array([fx, 0.0, cx, 0.0, fy, cy, 0.0, 0.0, 1.0]).reshape(3, 3)
    d_l = np.array([0.2624, -0.9531, -0.0054, 0.0026, 1.1633])

    images_list = sorted(glob.glob(os.path.join(datapath, "rgb",
                                                "*.png")))[::stride]
    data = []
    for t, imfile in enumerate(images_list):
        image = cv2.imread(imfile)
        image = cv2.undistort(image, K_l, d_l)
        image = cv2.resize(image, (image_size[1] + 32, image_size[0] + 16))

        intr = np.array([fx, fy, cx, cy])
        intr[0] *= image.shape[1] / 640.0
        intr[1] *= image.shape[0] / 480.0
        intr[2] *= image.shape[1] / 640.0
        intr[3] *= image.shape[0] / 480.0
        intr[2] -= 16
        intr[3] -= 8
        image = image[8:-8, 16:-16]
        data.append((t, image, intr.astype(np.float32)))
    return data


def tum_timestamps(datapath, stride=2):
    images_list = sorted(glob.glob(os.path.join(datapath, "rgb",
                                                "*.png")))[::stride]
    return np.array([float(os.path.basename(x)[:-4]) for x in images_list])


def eth3d_stream(datapath, use_depth=False, stride=1,
                 target_area=384 * 512):
    """test_eth3d.py:26-58: calibration.txt intrinsics, sqrt-area resize
    (to `target_area` pixels — the reference's hardcoded 384*512),
    depth/5000 at full res."""
    import cv2

    fx, fy, cx, cy = np.loadtxt(
        os.path.join(datapath, "calibration.txt")).tolist()
    image_list = sorted(glob.glob(os.path.join(datapath, "rgb",
                                               "*.png")))[::stride]
    depth_list = sorted(glob.glob(os.path.join(datapath, "depth",
                                               "*.png")))[::stride]

    for t, (image_file, depth_file) in enumerate(zip(image_list, depth_list)):
        image = cv2.imread(image_file)
        depth = cv2.imread(depth_file, cv2.IMREAD_ANYDEPTH) / 5000.0

        h0, w0, _ = image.shape
        h1 = int(h0 * np.sqrt(target_area / (h0 * w0)))
        w1 = int(w0 * np.sqrt(target_area / (h0 * w0)))
        image = cv2.resize(image, (w1, h1))
        image = image[: h1 - h1 % 8, : w1 - w1 % 8]
        depth = cv2.resize(depth, (w1, h1), interpolation=cv2.INTER_NEAREST)
        depth = depth[: h1 - h1 % 8, : w1 - w1 % 8]

        intr = np.array([fx, fy, cx, cy])
        intr[0::2] *= w1 / w0
        intr[1::2] *= h1 / h0

        if use_depth:
            yield t, image, depth, intr.astype(np.float32)
        else:
            yield t, image, intr.astype(np.float32)


def eth3d_timestamps(datapath, stride=1):
    data = np.loadtxt(os.path.join(datapath, "rgb.txt"), dtype=np.str_)
    return data[:, 0].astype(np.float64)[::stride]
