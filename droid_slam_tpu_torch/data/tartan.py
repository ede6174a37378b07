"""TartanAir: the training dataset and its evaluation stream.

A numpy copy of ``droid_slam_tpu/data/tartan.py``: the NED->XYZ pose
component remap [1,2,0,4,5,3,6], DEPTH_SCALE=5 on translations and depths,
the test-split exclusion and the calibration (320,320,320,240).
"""

from __future__ import annotations

import glob
import os.path as osp

import numpy as np

from .base import RGBDDataset, Scene, build_covis_index

# validation scenes reserved from training (data_readers/tartan_test.txt)
TEST_SPLIT = [
    "abandonedfactory/abandonedfactory/Easy/P011",
    "abandonedfactory/abandonedfactory/Hard/P011",
    "abandonedfactory_night/abandonedfactory_night/Easy/P013",
    "abandonedfactory_night/abandonedfactory_night/Hard/P014",
    "amusement/amusement/Easy/P008",
    "amusement/amusement/Hard/P007",
    "carwelding/carwelding/Easy/P007",
    "endofworld/endofworld/Easy/P009",
    "gascola/gascola/Easy/P008",
    "gascola/gascola/Hard/P009",
    "hospital/hospital/Easy/P044",
    "hospital/hospital/Hard/P049",
    "japanesealley/japanesealley/Easy/P007",
    "japanesealley/japanesealley/Hard/P005",
    "neighborhood/neighborhood/Easy/P021",
    "neighborhood/neighborhood/Hard/P017",
    "ocean/ocean/Easy/P013",
    "ocean/ocean/Hard/P009",
    "office2/office2/Easy/P011",
    "office2/office2/Hard/P010",
    "office/office/Hard/P007",
    "oldtown/oldtown/Easy/P007",
    "oldtown/oldtown/Hard/P008",
    "seasidetown/seasidetown/Easy/P009",
    "seasonsforest/seasonsforest/Easy/P011",
    "seasonsforest/seasonsforest/Hard/P006",
    "seasonsforest_winter/seasonsforest_winter/Easy/P009",
    "seasonsforest_winter/seasonsforest_winter/Hard/P018",
    "soulcity/soulcity/Easy/P012",
    "soulcity/soulcity/Hard/P009",
    "westerndesert/westerndesert/Easy/P013",
    "westerndesert/westerndesert/Hard/P007",
]


class TartanAir(RGBDDataset):
    DEPTH_SCALE = 5.0  # balance rotation & translation (tartan.py:21)

    def __init__(self, mode="training", **kwargs):
        self.mode = mode
        super().__init__(name="TartanAir", **kwargs)

    @staticmethod
    def is_test_scene(scene):
        return any(x in scene for x in TEST_SPLIT)

    def _scan_scenes(self):
        scenes = {}
        for scene in sorted(glob.glob(osp.join(self.root, "*/*/*/*"))):
            images = sorted(glob.glob(osp.join(scene, "image_left/*.png")))
            depths = sorted(glob.glob(osp.join(scene, "depth_left/*.npy")))
            if not images:
                continue
            poses = np.loadtxt(osp.join(scene, "pose_left.txt"),
                               delimiter=" ")
            poses = poses[:, [1, 2, 0, 4, 5, 3, 6]]  # NED -> XYZ
            poses[:, :3] /= TartanAir.DEPTH_SCALE
            intrinsics = np.tile(TartanAir.calib_read(), (len(images), 1))
            covis = build_covis_index(poses, depths, intrinsics,
                                      TartanAir.depth_read)
            scenes[scene] = Scene(images=images, depths=depths, poses=poses,
                                  intrinsics=intrinsics, covis=covis)
        return scenes

    @staticmethod
    def calib_read():
        return np.array([320.0, 320.0, 320.0, 240.0])

    @staticmethod
    def depth_read(depth_file):
        depth = np.load(depth_file) / TartanAir.DEPTH_SCALE
        depth[~np.isfinite(depth)] = 1.0
        return depth


def tartan_image_stream(scene_path, stride=1, stereo=False):
    """Evaluation stream: yields (t, image(s), intrinsics) for test_tartanair
    (evaluation_scripts/test_tartanair.py image_stream)."""
    import cv2

    images_left = sorted(glob.glob(osp.join(scene_path, "image_left/*.png")))
    images_right = sorted(glob.glob(osp.join(scene_path,
                                             "image_right/*.png")))
    intr = np.array([320.0, 320.0, 320.0, 240.0], np.float32)

    for t, imfile in enumerate(images_left[::stride]):
        images = [cv2.imread(imfile)]
        if stereo:
            images.append(cv2.imread(images_right[::stride][t]))
        images = np.stack(images)
        yield t, images if stereo else images[0], intr
