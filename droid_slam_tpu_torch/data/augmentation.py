"""Training augmentation: colour jitter, random grayscale, and a random
log-uniform rescale with a centre crop (intrinsics adjusted).

A numpy and OpenCV copy of ``droid_slam_tpu/data/augmentation.py``
(brightness, contrast and saturation 0.25, hue 0.4/pi, grayscale p=0.1, max
log2 scale 0.25), the upstream DROID-SLAM augmentor's behaviour.
"""

from __future__ import annotations

import numpy as np
import cv2


class RGBDAugmentor:
    def __init__(self, crop_size, rng=None):
        self.crop_size = crop_size
        self.max_scale = 0.25
        self.rng = rng or np.random.default_rng()

    # -- color -----------------------------------------------------------
    def color_transform(self, images):
        """images [N,H,W,3] BGR float32 in [0,255]; jitter applied jointly
        to all frames (augmentation.py:49-54 concatenates them)."""
        rng = self.rng
        b = 1.0 + rng.uniform(-0.25, 0.25)
        c = 1.0 + rng.uniform(-0.25, 0.25)
        s = 1.0 + rng.uniform(-0.25, 0.25)
        h = rng.uniform(-0.4 / np.pi, 0.4 / np.pi)  # radians -> hue frac

        x = images.astype(np.float32) / 255.0
        # brightness
        x = np.clip(x * b, 0, 1)
        # contrast (about the gray mean, torchvision semantics)
        mean = x.mean()
        x = np.clip((x - mean) * c + mean, 0, 1)
        # saturation + hue via HSV
        flat = x.reshape(-1, *x.shape[2:])
        hsv = cv2.cvtColor((flat * 255).astype(np.uint8).reshape(
            -1, x.shape[2], 3), cv2.COLOR_BGR2HSV).astype(np.float32)
        hsv[..., 1] = np.clip(hsv[..., 1] * s, 0, 255)
        hsv[..., 0] = (hsv[..., 0] + h * 180.0) % 180.0
        out = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2BGR)
        x = out.reshape(x.shape).astype(np.float32)

        if rng.uniform() < 0.1:  # random grayscale
            g = x @ np.array([0.114, 0.587, 0.299], np.float32)  # BGR weights
            x = np.repeat(g[..., None], 3, axis=-1)
        return x

    # -- spatial ---------------------------------------------------------
    def spatial_transform(self, images, depths, poses, intrinsics):
        """augmentation.py:20-47."""
        n, ht, wd = images.shape[:3]
        min_scale = np.log2(max((self.crop_size[0] + 1) / float(ht),
                                (self.crop_size[1] + 1) / float(wd)))
        scale = 2 ** self.rng.uniform(min_scale, self.max_scale)

        h1, w1 = int(round(ht * scale)), int(round(wd * scale))
        intrinsics = intrinsics * scale

        images = np.stack([cv2.resize(im, (w1, h1),
                                      interpolation=cv2.INTER_LINEAR)
                           for im in images])
        depths = np.stack([cv2.resize(d, (w1, h1),
                                      interpolation=cv2.INTER_NEAREST)
                           for d in depths])

        y0 = (h1 - self.crop_size[0]) // 2
        x0 = (w1 - self.crop_size[1]) // 2
        intrinsics = intrinsics - np.array([0.0, 0.0, x0, y0], np.float32)
        images = images[:, y0:y0 + self.crop_size[0],
                        x0:x0 + self.crop_size[1]]
        depths = depths[:, y0:y0 + self.crop_size[0],
                        x0:x0 + self.crop_size[1]]
        return images, poses, depths, intrinsics

    def __call__(self, images, poses, depths, intrinsics):
        """images [N,H,W,3] BGR float; depths [N,H,W]; returns same layout."""
        images = self.color_transform(images)
        return self.spatial_transform(images, depths, poses, intrinsics)
