"""DepthVideo: the keyframe buffers, as plain tensors on one device.

Counterpart of ``droid_slam_tpu/state/video.py``. Buffers (capacity B,
image H x W, feature resolution h = H/8, w = W/8, c = 2 views per keyframe
in stereo, else 1):
  tstamp [B]   poses [B,7] (world-to-camera, [t,q])   disps [B,h,w]
  disps_sens [B,h,w] (sensor inverse depth, 0 where there is none)
  disps_up [B,H,W] (full-resolution disparities; only with ``upsample``)
  intrinsics [B,4] (at 1/8 scale)   damping [B,h,w]
  fmaps [B,c,128,h,w]   nets/inps [B,128,h,w]   bf16, NCHW (PyTorch's
  convolution layout)
  images: the keyframes' (left) images, host-side, for export

Writers hold the video's lock (``get_lock()``, reentrant), so that the
asynchronous backend can copy a consistent slice of it (``read_frames``)
while the tracker runs.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..geom import projective as pops
from ..ops import frame_distance_cuda
from ..lie import se3
from ..ba import inference as ba_inf
from ..utils import trace


def sensor_disparity(depth) -> np.ndarray:
    """Full-resolution depth [H,W] -> inverse depth at the feature pixels
    ([3::8, 3::8]), 0 where the depth is not positive
    (droid_slam_tpu/state/video.py:167-170)."""
    dep = np.asarray(depth, np.float32)[3::8, 3::8]
    return np.where(dep > 0, 1.0 / np.where(dep > 0, dep, 1.0), 0.0)


class DepthVideo:
    def __init__(self, image_size=(480, 640), buffer: int = 512,
                 device="cuda", stereo: bool = False, upsample: bool = False):
        ht, wd = image_size
        self.h, self.w = h, w = ht // 8, wd // 8
        self.buffer = buffer
        self.stereo = stereo
        self.device = dev = torch.device(device)
        c = 2 if stereo else 1
        f32, bf16 = torch.float32, torch.bfloat16
        self.tstamp = torch.zeros(buffer, dtype=f32, device=dev)
        self.poses = se3.identity((buffer,), f32, dev)
        self.disps = torch.ones((buffer, h, w), dtype=f32, device=dev)
        self.disps_sens = torch.zeros((buffer, h, w), dtype=f32, device=dev)
        self.disps_up = (torch.zeros((buffer, ht, wd), dtype=f32, device=dev)
                         if upsample else None)
        self.intrinsics = torch.zeros((buffer, 4), dtype=f32, device=dev)
        self.damping = torch.full((buffer, h, w), 1e-6, dtype=f32, device=dev)
        self.fmaps = torch.zeros((buffer, c, 128, h, w), dtype=bf16,
                                 device=dev)
        self.nets = torch.zeros((buffer, 128, h, w), dtype=bf16, device=dev)
        self.inps = torch.zeros((buffer, 128, h, w), dtype=bf16, device=dev)
        self.images = [None] * buffer
        self.counter = 0
        self.ready = False  # set once the tracker is initialized
        self.dirty = np.zeros(buffer, bool)  # frames changed since last read
        self._lock = threading.RLock()

    _FIELDS = ("tstamp", "poses", "disps", "disps_sens", "disps_up",
               "intrinsics", "damping", "fmaps", "nets", "inps")
    # the per-frame fields the asynchronous backend copies
    # (droid_slam_tpu/slam/async_droid.py:87-119)
    FRAME_FIELDS = ("tstamp", "poses", "disps", "disps_sens", "intrinsics",
                    "fmaps", "nets", "inps")

    def get_lock(self):
        return self._lock

    def append(self, tstamp, **fields):
        """Write the next keyframe; fields left None keep their values
        (the motion model has already written the pose and disparity)."""
        return self.set_frame(self.counter, tstamp, **fields)

    def set_frame(self, ix, tstamp, pose=None, disp=None, depth=None,
                  intrinsics=None, fmap=None, net=None, inp=None,
                  image=None, defer=False):
        """Write frame ix (the counter grows to cover it); fields left None
        keep their values. ``depth`` is a full-resolution depth map [H,W]
        (``sensor_disparity``); ``fmap`` is [c,128,h,w], or one view
        [128,h,w] written to every view; ``image`` is kept host-side.

        With ``defer`` the device fields are not written: (ix, values,
        fields) is returned for the frame program to write
        (``write_frame``; droid_slam_tpu/state/video.py:144-188), and only
        the image, the counter and the dirty flag change here."""
        if ix >= self.buffer:
            raise RuntimeError(
                f"DepthVideo buffer full: keyframe index {ix} >= buffer "
                f"{self.buffer}; raise the buffer or filter_thresh")
        if defer:
            values = {"tstamp": float(tstamp), "poses": pose, "disps": disp,
                      "disps_sens": (None if depth is None
                                     else sensor_disparity(depth)),
                      "intrinsics": (None if intrinsics is None else
                                     np.asarray(intrinsics, np.float32)),
                      "fmaps": fmap, "nets": net, "inps": inp}
            values = {k: v for k, v in values.items() if v is not None}
            with self._lock:
                if image is not None:
                    self.images[ix] = image
                self.counter = max(self.counter, ix + 1)
                self.dirty[ix] = True
            return ix, values, tuple(sorted(values))
        with self._lock:
            if image is not None:
                self.images[ix] = image
            self.tstamp[ix] = float(tstamp)
            if pose is not None:
                self.poses[ix] = pose
            if disp is not None:
                self.disps[ix] = disp
            if depth is not None:
                self.disps_sens[ix] = torch.as_tensor(sensor_disparity(depth),
                                                      device=self.device)
            if intrinsics is not None:
                self.intrinsics[ix] = torch.as_tensor(
                    np.asarray(intrinsics, np.float32), device=self.device)
            for buf, val in ((self.fmaps, fmap), (self.nets, net),
                             (self.inps, inp)):
                if val is not None:
                    buf[ix] = val
            self.counter = max(self.counter, ix + 1)
            self.dirty[ix] = True

    def rm_keyframe(self, ix: int):
        """Remove keyframe ix: shift [ix+1, counter) down one slot."""
        with self._lock:
            t = self.counter
            for name in self._FIELDS:
                buf = getattr(self, name)
                if buf is not None:
                    buf[ix:t - 1] = buf[ix + 1:t].clone()
            self.images[ix:t - 1] = self.images[ix + 1:t]

    def normalize(self):
        """Rescale the keyframes' mean disparity to 1 (monocular scale)."""
        with self._lock:
            t = self.counter
            s = self.disps[:t].mean()
            self.disps[:t] /= s
            self.poses[:t, :3] *= s
            self.dirty[:t] = True

    def read_frames(self, t0, t1):
        """Copies of frames [t0, t1) of ``FRAME_FIELDS``, and their images,
        under the lock; a caller that reads the counter or other fields
        with them holds the lock across all of it."""
        with self._lock:
            out = {name: getattr(self, name)[t0:t1].clone()
                   for name in self.FRAME_FIELDS}
            out["images"] = list(self.images[t0:t1])
        return out

    def write_frames(self, t0, frames):
        """Write ``frames`` (as ``read_frames`` returns them, images
        optional) at [t0, t0+n); the counter becomes t0+n."""
        t1 = t0 + len(frames["tstamp"])
        with self._lock:
            for name in self.FRAME_FIELDS:
                getattr(self, name)[t0:t1] = frames[name]
            if "images" in frames:
                self.images[t0:t1] = frames["images"]
            self.counter = t1
            self.dirty[t0:t1] = True

    def reproject(self, ii, jj):
        """Pixels of frames ii warped into frames jj: (coords [E,h,w,2],
        valid [E,h,w,1])."""
        ii = torch.as_tensor(np.atleast_1d(ii), device=self.device)
        jj = torch.as_tensor(np.atleast_1d(jj), device=self.device)
        coords, valid, _ = pops.projective_transform(
            self.poses, self.disps, self.intrinsics, ii, jj)
        return coords, valid

    # most pairs per call of the plain twin on the CPU: each pair holds ~70
    # bytes per pixel of warped points and temporaries, so the backend's
    # proposal over all t^2 pairs (1M at t=1000) runs in chunks, as in
    # droid_slam_tpu/state/video.py:225-244. The CUDA kernel holds none and
    # takes every pair in one launch
    _DIST_CHUNK = 32768

    def distance(self, ii, jj, beta=0.3, bidirectional=True):
        """Frame distance of each pair (ii[k], jj[k]) -> [len(ii)] tensor:
        on a card one ``ops/frame_distance_cuda.py`` launch, on the CPU
        its twin ``_DIST_CHUNK`` pairs at a time; the span
        ``droid:distance``."""
        with trace.span("distance"):
            ii = torch.as_tensor(np.atleast_1d(ii), device=self.device)
            jj = torch.as_tensor(np.atleast_1d(jj), device=self.device)
            n = max(len(ii), 1)
            step = self._DIST_CHUNK if self.device.type == "cpu" else n
            return torch.cat([
                frame_distance_cuda.frame_distance(
                    self.poses, self.disps, self.intrinsics[0],
                    ii[s:s + step], jj[s:s + step], beta,
                    bidirectional=bidirectional)
                for s in range(0, n, step)])

    def ba(self, target, weight, plan, iters=2, lm=1e-4, ep=0.1,
           motion_only=False):
        """Dense BA over the plan's edges (target/weight [E,2,HW]), with the
        sensor disparities as a prior where they are set; the span
        ``droid:ba``."""
        with trace.span("ba"):
            poses, disps = ba_inf.ba_iterations(
                self.poses, self.disps, self.disps_sens, self.damping,
                self.intrinsics[0], target, weight, plan, lm=lm, ep=ep,
                iters=iters, motion_only=motion_only)
            with self._lock:
                # in place: the frame path's captured programs read these
                # buffers at the addresses they saw at capture
                self.poses.copy_(poses)
                self.disps.copy_(disps)


def write_frame(video, index, values, fields):
    """Write one keyframe's ``fields`` inside the frame program: ``index``
    is a device scalar, and a row past the buffer (the sentinel of a
    rejected or mis-speculated frame) writes nothing. ``values`` holds
    device tensors. Counterpart of
    ``droid_slam_tpu/state/video.py::_write_frame_traced``."""
    B = video.buffer
    ok = (index >= 0) & (index < B)
    row = index.clamp(0, B - 1).reshape(1)
    for name in fields:
        buf = getattr(video, name)
        val = values[name].to(buf.dtype).expand(buf.shape[1:])
        old = buf.index_select(0, row)[0]
        buf.index_copy_(0, row, torch.where(ok, val, old)[None])
