"""Training frame graphs from the flow distance between frames (a copy of
``droid_slam_tpu/data/graph_utils.py``)."""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from .rgbd_utils import compute_distance_matrix_flow


def graph_to_edge_list(graph):
    """graph_utils.py:10-21."""
    ii, jj, kk = [], [], []
    for s, u in enumerate(graph):
        for v in graph[u]:
            ii.append(u)
            jj.append(v)
            kk.append(s)
    return np.asarray(ii), np.asarray(jj), np.asarray(kk)


def keyframe_indicies(graph):
    return np.asarray(list(graph))


def neighbourhood_graph(n, r):
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    d = np.abs(ii - jj)
    keep = (d >= 1) & (d <= r)
    return ii[keep], jj[keep]


def build_frame_graph(poses, disps, intrinsics, num=16, thresh=24.0, r=2):
    """graph_utils.py:37-68: covisibility graph for a training video.
    poses [N,7] c2w numpy; disps full-res (subsampled [3::8,3::8] here);
    intrinsics [N,4] full-res."""
    N = poses.shape[0]
    d = compute_distance_matrix_flow(
        poses, disps[:, 3::8, 3::8], intrinsics / 8.0)

    count = 0
    graph = OrderedDict()
    for i in range(N):
        graph[i] = []
        d[i, i] = np.inf
        for j in range(i - r, i + r + 1):
            if 0 <= j < N and i != j:
                graph[i].append(j)
                d[i, j] = np.inf
                count += 1

    while count < num:
        ix = np.argmin(d)
        i, j = ix // N, ix % N
        if d[i, j] < thresh:
            graph[i].append(j)
            d[i, j] = np.inf
            count += 1
        else:
            break
    return graph
