"""The box walk (``box_walk.py``) seen by a rectified stereo rig: the right
camera is the left one moved ``baseline`` along its own x axis, with the
same orientation and intrinsics, and both views are rendered by the same
exact ray casting, so the pair is photo-consistent at every depth."""

from __future__ import annotations

import numpy as np

from benchmark.traffic import box_walk


def right_centres(Rs, ts, baseline):
    """Camera-to-world centres of the right views: t + R @ [baseline, 0,
    0]."""
    return (ts + baseline * Rs[:, :, 0]).astype(np.float32)


def stream(n_frames, image_size, walk_seed, seed, step, rot_step, baseline,
           device):
    """(pairs uint8 [N,2,H,W,3] on the host, left view first, intrinsics
    [4]): ``box_walk.stream``'s walk and texture, each frame also rendered
    from the right camera."""
    H, W = image_size
    Rs, ts, _, intr = box_walk.walk(n_frames, image_size, walk_seed, step,
                                    rot_step)
    texture = int(np.random.default_rng(seed).integers(1, 2 ** 20))
    out = np.empty((n_frames, 2, H, W, 3), np.uint8)
    for view, centres in enumerate((ts, right_centres(Rs, ts, baseline))):
        out[:, view] = box_walk.render_torch(Rs, centres, intr, image_size,
                                             texture, device)
    return out, intr
