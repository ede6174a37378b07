"""MotionFilter: per-frame feature extraction and keyframe admission.

Counterpart of ``droid_slam_tpu/slam/motion_filter.py`` on its per-call
path. Every frame is encoded in bf16: fnet on each of its views (one, or a
stereo pair), cnet on the left view. One zero-flow update of the left views
against the last keyframe gives the mean flow-correction magnitude, and the
frame is admitted as a keyframe when it exceeds the threshold. The test for
frame t is begun when t arrives (``track_begin``) and resolved when t+1
arrives (``track_finish``), as in the JAX pipeline; an admitted frame takes
its depth map (RGB-D) into the video with it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geom import projective as pops
from ..lie import se3
from ..models import nets
from ..ops import corr as corr_ops
from ..ops import corr_cuda

_BF16 = torch.bfloat16


def encode_fnet(params, images):
    """The feature encoder alone, in bf16, on a batch of uint8 BGR images
    [M,H,W,3] -> fmaps [M,128,h,w] (the trajectory filler's encoder)."""
    x = nets.normalize_images(images).to(_BF16)
    return nets.basic_encoder(params, "fnet", x, norm=True)


class MotionFilter:
    def __init__(self, params, video, thresh: float = 2.5):
        self.params = params
        self.video = video
        self.thresh = thresh
        self.fmap = self.net = self.inp = None  # last keyframe's features
        self._pending = None

    def _encode(self, views):
        """views [c,H,W,3] uint8 -> fmaps [c,128,h,w] of every view, and
        the left view's net, inp [128,h,w]."""
        fmap, net, inp = nets.extract_features(self.params, views,
                                               compute_dtype=_BF16,
                                               cnet_views=1)
        return fmap, net[0], inp[0]

    def _delta(self, fmap):
        """Mean |flow correction| of one zero-flow update of the left views
        vs the last keyframe (the second call site of the corr-window
        lookup)."""
        h, w = fmap.shape[-2:]
        pyramid = corr_ops.build_pyramid(self.fmap[:1], fmap[:1])
        coords0 = pops.coords_grid(h, w, device=fmap.device)
        slots = torch.zeros(1, dtype=torch.int32, device=fmap.device)
        corr = corr_cuda.lookup_pyramid_slots(
            pyramid, slots, coords0.reshape(1, h * w, 2))
        corr = corr.to(_BF16).transpose(1, 2).reshape(1, -1, h, w)
        _, delta, _ = nets.update_module(self.params, self.net[None],
                                         self.inp[None], corr)
        return delta.float().norm(dim=1).mean()

    def track_begin(self, tstamp, image, depth, intrinsics):
        """Encode the frame (a [H,W,3] image is a stack of one view) and
        start its admission test."""
        image = np.asarray(image)
        if image.ndim == 3:
            image = image[None]
        views = torch.as_tensor(image, device=self.video.device)
        fmap, net, inp = self._encode(views)
        if self.video.counter == 0 and self._pending is None:
            # the first frame is always a keyframe: pose Id, disparity 1
            self.fmap, self.net, self.inp = fmap, net, inp
            self.video.append(tstamp, pose=se3.identity(device=fmap.device),
                              disp=1.0, depth=depth,
                              intrinsics=np.asarray(intrinsics) / 8.0,
                              fmap=fmap, net=net, inp=inp, image=image[0])
            return
        self._pending = (tstamp, image[0], depth, intrinsics, fmap, net, inp,
                         self._delta(fmap))

    def track_finish(self):
        """Resolve the pending test; append the frame when admitted."""
        if self._pending is None:
            return
        tstamp, image, depth, intrinsics, fmap, net, inp, delta = \
            self._pending
        self._pending = None
        if float(delta) > self.thresh:
            self.fmap, self.net, self.inp = fmap, net, inp
            self.video.append(tstamp, depth=depth,
                              intrinsics=np.asarray(intrinsics) / 8.0,
                              fmap=fmap, net=net, inp=inp, image=image)
