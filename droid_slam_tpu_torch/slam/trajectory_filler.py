"""PoseTrajectoryFiller: poses for the frames that are not keyframes.

Counterpart of ``droid_slam_tpu/slam/trajectory_filler.py``. For each batch
of 16 frames: SE3 interpolation between the bracketing keyframes, the frames
written temporarily into the video at [N, N+M), two anchor factors per frame
(to the keyframes before and after it), 6 motion-only update iterations, and
the temporary frames popped again. Where the buffer has no room for the
batch it is split to what fits; with a full buffer the interpolated poses are
returned as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from ..lie import se3
from ..state.graph import FactorGraph
from .motion_filter import encode_fnet

BATCH = 16


class PoseTrajectoryFiller:
    def __init__(self, params, video, fused_epilogue: bool = False):
        self.params = params
        self.video = video
        self.fused_epilogue = fused_epilogue

    def _fill(self, tstamps, images, intrinsics):
        """World-to-camera poses [M,7] (numpy) of one batch."""
        v = self.video
        N, M = v.counter, len(tstamps)
        ts = v.tstamp[:N].cpu().numpy()
        Ps = v.poses[:N]

        t0 = np.array([max(int(np.sum(ts <= t)) - 1, 0) for t in tstamps])
        t1 = np.where(t0 < N - 1, t0 + 1, t0)
        as_f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                           device=v.device)[:, None]
        P0 = Ps[torch.as_tensor(t0, device=v.device)]
        P1 = Ps[torch.as_tensor(t1, device=v.device)]
        dt = as_f32(ts[t1] - ts[t0] + 1e-3)
        w = se3.log(se3.mul(P1, se3.inv(P0))) / dt \
            * as_f32(np.asarray(tstamps) - ts[t0])
        Gs = se3.mul(se3.exp(w), P0)

        # the temporary frames need slots [N, N+M) of the buffer
        avail = v.buffer - N
        if avail <= 0:
            return Gs.cpu().numpy()
        if M > avail:
            return np.concatenate([
                self._fill(tstamps[:avail], images[:avail],
                           intrinsics[:avail]),
                self._fill(tstamps[avail:], images[avail:],
                           intrinsics[avail:])])

        imgs = torch.as_tensor(np.stack(images), device=v.device)
        fmaps = encode_fnet(self.params, imgs)
        for k in range(M):
            v.set_frame(N + k, tstamps[k], pose=Gs[k], disp=1.0,
                        intrinsics=np.asarray(intrinsics[k]) / 8.0,
                        fmap=fmaps[k])
        graph = FactorGraph(v, self.params,
                            fused_epilogue=self.fused_epilogue)
        graph.add_factors(t0, np.arange(N, N + M))
        graph.add_factors(t1, np.arange(N, N + M))
        graph.update(N, N + M, motion_only=True, n_iters=6)
        # a copy: on the CPU .numpy() would alias the buffer that the next
        # batch writes
        out = v.poses[N:N + M].cpu().numpy().copy()
        v.counter = N
        return out

    def __call__(self, image_stream):
        """image_stream yields (tstamp, image, intrinsics [4]); the image is
        uint8 BGR [H,W,3], or a stereo stack [2,H,W,3] of which the left
        view is taken. Returns world-to-camera poses [T,7] (numpy) for
        every frame of the stream."""
        poses, batch = [], []
        for tstamp, image, intrinsics in image_stream:
            image = np.asarray(image)
            if image.ndim == 4:
                image = image[0]
            batch.append((tstamp, image, intrinsics))
            if len(batch) == BATCH:
                poses.append(self._fill(*zip(*batch)))
                batch = []
        if batch:
            poses.append(self._fill(*zip(*batch)))
        return np.concatenate(poses)
