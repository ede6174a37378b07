"""Covisibility-sampled training videos.

A numpy copy of ``droid_slam_tpu/data/base.py``: scenes are indexed once
into a flow-distance covisibility structure (cached on disk beside the
data), and each sample is an n_frames clip drawn by a random covisibility
walk bounded by [fmin, fmax] px of optical flow, augmented and
scale-normalized. The index is a CSR adjacency (``CovisIndex``); the clip
sampler and the scale normalizer are pure functions; ``RGBDDataset`` is a
thin composition layer that datasets (``TartanAir``) specialize with reader
hooks.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
from dataclasses import dataclass, field

import numpy as np

from .augmentation import RGBDAugmentor
from .rgbd_utils import compute_distance_matrix_flow


# ---------------------------------------------------------------------------
# Covisibility index (CSR adjacency over frames of one scene)
# ---------------------------------------------------------------------------

@dataclass
class CovisIndex:
    """Sparse frame-adjacency: frame i's covisible neighbours are
    ``idx[ptr[i]:ptr[i+1]]`` with flow magnitudes ``flow[ptr[i]:ptr[i+1]]``."""

    ptr: np.ndarray   # [N+1] int32
    idx: np.ndarray   # [nnz] int32
    flow: np.ndarray  # [nnz] float32

    @property
    def num_frames(self) -> int:
        return len(self.ptr) - 1

    def neighbours(self, i: int):
        lo, hi = self.ptr[i], self.ptr[i + 1]
        return self.idx[lo:hi], self.flow[lo:hi]

    def degree(self, i: int) -> int:
        return int(self.ptr[i + 1] - self.ptr[i])

    @classmethod
    def from_dense(cls, dist: np.ndarray, max_flow: float) -> "CovisIndex":
        """Sparsify an all-pairs flow-distance matrix (inf = not covisible)."""
        keep = dist < max_flow
        counts = keep.sum(axis=1).astype(np.int32)
        ptr = np.zeros(len(dist) + 1, np.int32)
        np.cumsum(counts, out=ptr[1:])
        cols = np.nonzero(keep)[1].astype(np.int32)
        return cls(ptr=ptr, idx=cols, flow=dist[keep].astype(np.float32))


def build_covis_index(poses, depth_files, intrinsics, depth_read,
                      stride: int = 16, max_flow: float = 256.0) -> CovisIndex:
    """Flow-distance covisibility at 1/stride resolution."""
    off = stride // 2

    def disp_of(fn):
        depth = depth_read(fn)[off::stride, off::stride]
        depth = np.where(depth < 0.01, depth[depth >= 0.01].mean()
                         if (depth >= 0.01).any() else 1.0, depth)
        return 1.0 / depth

    disps = np.stack([disp_of(f) for f in depth_files], axis=0)
    dist = stride * compute_distance_matrix_flow(
        np.asarray(poses), disps, np.asarray(intrinsics) / stride)
    return CovisIndex.from_dense(dist, max_flow)


# ---------------------------------------------------------------------------
# Pure samplers / transforms
# ---------------------------------------------------------------------------

def covisibility_walk(covis: CovisIndex, anchor: int, n_frames: int,
                      fmin: float, fmax: float, rng) -> list[int]:
    """Random walk over covisible frames with flow in (fmin, fmax),
    preferring forward-in-time steps; repeats the current frame when no
    neighbour qualifies (base.py:120-133 semantics)."""
    clip = [anchor]
    cur = anchor
    while len(clip) < n_frames:
        nbrs, flow = covis.neighbours(cur)
        ok = nbrs[(flow > fmin) & (flow < fmax)]
        fwd = ok[ok > cur]
        pool = fwd if fwd.size else ok
        if pool.size:
            cur = int(rng.choice(pool))
        clip.append(cur)
    return clip


def normalize_clip_scale(poses: np.ndarray, disps: np.ndarray):
    """Rescale so mean valid disparity is 1 (base.py:144-148)."""
    valid = disps > 0.01
    if valid.any():
        s = disps[valid].mean()
        disps = disps / s
        poses = poses.copy()
        poses[..., :3] *= s
    return poses, disps


def anchor_frames(covis: CovisIndex, n_frames: int) -> np.ndarray:
    """Frames with enough covisible neighbours to anchor a clip."""
    deg = np.diff(covis.ptr)
    return np.nonzero(deg > n_frames)[0]


# ---------------------------------------------------------------------------
# Scene table + dataset
# ---------------------------------------------------------------------------

@dataclass
class Scene:
    images: list  # paths
    depths: list  # paths
    poses: np.ndarray       # [N,7] camera-to-world [t,q]
    intrinsics: np.ndarray  # [N,4]
    covis: CovisIndex = field(default=None)


def _index_cache(cache_dir: str | None, root: str, name: str) -> str:
    """The index cache's file: under ``cache_dir``, by default beside the
    data (``<datapath>/.index_cache``)."""
    cache_dir = cache_dir or osp.join(root, ".index_cache")
    os.makedirs(cache_dir, exist_ok=True)
    return osp.join(cache_dir, f"{name}.index.pkl")


class RGBDDataset:
    """Thin composition layer over the functional pieces above.

    Concrete datasets provide ``_scan_scenes() -> dict[str, Scene]`` (with
    ``covis`` filled via :func:`build_covis_index`) plus the reader hooks
    ``image_read`` / ``depth_read`` and the ``is_test_scene`` split filter.
    """

    def __init__(self, name, datapath, n_frames=4, crop_size=(384, 512),
                 fmin=8.0, fmax=75.0, do_aug=True, cache_dir=None, rng=None):
        self.root = datapath
        self.name = name
        self.n_frames = n_frames
        self.fmin = fmin
        self.fmax = fmax
        self.rng = rng or np.random.default_rng()
        self.aug = RGBDAugmentor(crop_size, rng=self.rng) if do_aug else None

        cache = _index_cache(cache_dir, datapath, name)
        if osp.isfile(cache):
            with open(cache, "rb") as f:
                self.scenes = pickle.load(f)
        else:
            self.scenes = self._scan_scenes()
            with open(cache, "wb") as f:
                pickle.dump(self.scenes, f)

        self.samples = [
            (sid, int(a))
            for sid, scene in self.scenes.items()
            if not self.__class__.is_test_scene(sid)
            for a in anchor_frames(scene.covis, self.n_frames)
        ]

    # -- reader hooks -------------------------------------------------------

    @staticmethod
    def image_read(image_file):
        import cv2
        return cv2.imread(image_file)

    @staticmethod
    def depth_read(depth_file):
        return np.load(depth_file)

    @staticmethod
    def is_test_scene(scene):
        return False

    def _scan_scenes(self) -> dict:
        raise NotImplementedError

    # -- sampling -----------------------------------------------------------

    def __getitem__(self, index):
        """(images [N,H,W,3] f32 BGR, poses [N,7] c2w, disps [N,H,W],
        intrinsics [N,4]) for one covisibility-walk clip."""
        sid, anchor = self.samples[index % len(self.samples)]
        scene = self.scenes[sid]
        frames = covisibility_walk(scene.covis, anchor, self.n_frames,
                                   self.fmin, self.fmax, self.rng)

        cls = self.__class__
        images = np.stack([cls.image_read(scene.images[i])
                           for i in frames]).astype(np.float32)
        disps = 1.0 / np.stack([cls.depth_read(scene.depths[i])
                                for i in frames]).astype(np.float32)
        poses = scene.poses[frames].astype(np.float32)
        intrinsics = scene.intrinsics[frames].astype(np.float32)

        if self.aug is not None:
            images, poses, disps, intrinsics = self.aug(
                images, poses, disps, intrinsics)

        poses, disps = normalize_clip_scale(poses, disps)
        return images, poses, disps, intrinsics

    def __len__(self):
        return len(self.samples)
