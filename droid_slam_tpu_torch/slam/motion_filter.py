"""MotionFilter: per-frame feature extraction and keyframe admission.

Counterpart of ``droid_slam_tpu/slam/motion_filter.py`` on its per-call
path. Every frame is encoded in bf16: fnet on each of its views (one, or a
stereo pair), cnet on the left view. One zero-flow update of the left views
against the last keyframe gives the mean flow-correction magnitude, and the
frame is admitted as a keyframe when it exceeds the threshold. The test for
frame t is begun when t arrives (``track_begin``) and resolved when t+1
arrives (``track_finish``), as in the JAX pipeline; an admitted frame takes
its depth map (RGB-D) into the video with it.

On the frame path (``slam/fused_frame.py``) the encode and the admission
delta run inside the frame program: ``track_begin(defer=True)`` only
stashes the frame and returns the proximity probe's pair tables,
``track_begin_complete`` stashes the program's encode, and
``track_finish(defer=True, resolved=...)`` takes the delta and the probe
distances from the program's readback and returns the keyframe write for
the next program (droid_slam_tpu/slam/motion_filter.py:119-229).
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


def encode_delta(params, views, fmap_prev, net_prev, inp_prev):
    """views [c,H,W,3] uint8 -> (fmaps [c,128,h,w] of every view, the left
    view's net and inp [128,h,w], and the admission delta: the mean
    |flow correction| of one zero-flow update of the left views against
    the keyframe whose features are given (the second call site of the
    corr-window lookup)). No value leaves the device."""
    fmap, net, inp = nets.extract_features(params, views,
                                           compute_dtype=_BF16, cnet_views=1)
    h, w = fmap.shape[-2:]
    pyramid = corr_ops.build_pyramid(fmap_prev[:1], fmap[:1])
    coords0 = pops.coords_grid(h, w, device=fmap.device)
    slots = torch.zeros(1, dtype=torch.int32, device=fmap.device)
    corr = corr_cuda.lookup_pyramid_slots(
        pyramid, slots, coords0.reshape(1, h * w, 2))
    corr = corr.to(_BF16).transpose(1, 2).reshape(1, -1, h, w)
    _, delta, _ = nets.update_module(params, net_prev[None], inp_prev[None],
                                     corr)
    return fmap, net[0], inp[0], delta.float().norm(dim=1).mean()


class MotionFilter:
    def __init__(self, params, video, thresh: float = 2.5,
                 proximity_probe=None):
        self.params = params
        self.video = video
        self.thresh = thresh
        self.count = 0  # frames rejected since the last keyframe
        self.fmap = self.net = self.inp = None  # last keyframe's features
        self._pending = None
        # the frame path: callable () -> (pair_ii, pair_jj) of the
        # frontend's next proximity proposal, the sticky pair bucket, and
        # the distances the last resolved frame program probed
        self.proximity_probe = proximity_probe
        self._pb_bucket = 64
        self.pending_distance = None

    def _pair_tables(self):
        """The probe's pairs padded to the sticky bucket, and the number of
        real pairs (droid_slam_tpu/slam/motion_filter.py:119)."""
        pair_ii, pair_jj = (self.proximity_probe()
                            if self.proximity_probe is not None
                            else (np.zeros(1, np.int64),) * 2)
        n = len(pair_ii)
        while self._pb_bucket < n:
            self._pb_bucket *= 2
        pi = np.zeros(self._pb_bucket, np.int64)
        pj = np.zeros(self._pb_bucket, np.int64)
        pi[:n], pj[:n] = pair_ii, pair_jj
        return pi, pj, n

    def track_begin(self, tstamp, image, depth, intrinsics, defer=False):
        """Encode the frame (a [H,W,3] image is a stack of one view) and
        start its admission test. With ``defer`` (the frame path) nothing
        runs: the frame is stashed and the probe's (pair_ii, pair_jj) are
        returned for the frame program."""
        image = np.asarray(image)
        if image.ndim == 3:
            image = image[None]
        if self.video.counter == 0 and self._pending is None:
            # the first frame is always a keyframe: pose Id, disparity 1
            views = torch.as_tensor(image, device=self.video.device)
            fmap, net, inp = nets.extract_features(
                self.params, views, compute_dtype=_BF16, cnet_views=1)
            self.fmap, self.net, self.inp = fmap, net[0], inp[0]
            self.video.append(tstamp, pose=se3.identity(device=fmap.device),
                              disp=1.0, depth=depth,
                              intrinsics=np.asarray(intrinsics) / 8.0,
                              fmap=fmap, net=net[0], inp=inp[0],
                              image=image[0])
            return None
        if defer:
            pi, pj, n = self._pair_tables()
            self._pending = (tstamp, image[0], depth, intrinsics, None, None,
                             None, None, n)
            return pi, pj
        views = torch.as_tensor(image, device=self.video.device)
        fmap, net, inp, delta = encode_delta(self.params, views, self.fmap,
                                             self.net, self.inp)
        self._pending = (tstamp, image[0], depth, intrinsics, fmap, net, inp,
                         delta, 0)
        return None

    def track_begin_complete(self, fmap, net, inp):
        """Stash the frame program's encode of the deferred frame."""
        tstamp, image, depth, intrinsics, _, _, _, _, n = self._pending
        self._pending = (tstamp, image, depth, intrinsics, fmap, net, inp,
                         None, n)

    def track_finish(self, defer=False, resolved=None):
        """Resolve the pending test; append the frame when admitted.

        With ``defer`` (the frame path), ``resolved`` = (delta, probe
        distances) from the readback, and the return value is the keyframe
        write (index, values, fields) for the next frame program: the index
        is past the buffer when the frame was rejected, so that the
        program's key stays the same and its write is dropped."""
        if self._pending is None:
            return None
        tstamp, image, depth, intrinsics, fmap, net, inp, delta, n = \
            self._pending
        self._pending = None
        if resolved is not None:
            delta, dists = resolved
            self.pending_distance = np.asarray(dists)[:n]
        admitted = float(delta) > self.thresh
        intr = np.asarray(intrinsics) / 8.0
        if admitted:
            self.count = 0
            out = self.video.append(tstamp, depth=depth, intrinsics=intr,
                                    fmap=fmap, net=net, inp=inp, image=image,
                                    defer=defer)
            if defer:
                # the program writes the row before anything reads it: the
                # last keyframe's features are the video's own
                i = self.video.counter - 1
                v = self.video
                self.fmap, self.net, self.inp = v.fmaps[i], v.nets[i], \
                    v.inps[i]
            else:
                self.fmap, self.net, self.inp = fmap, net, inp
            return out
        self.count += 1
        if defer:
            v = self.video
            _, values, fields = v.set_frame(v.counter, tstamp, depth=depth,
                                            intrinsics=intr, fmap=fmap,
                                            net=net, inp=inp, defer=True)
            v.counter -= 1
            v.dirty[v.counter] = False
            return v.buffer + 1, values, fields
        return None
