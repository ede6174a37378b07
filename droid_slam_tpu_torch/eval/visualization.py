"""The reconstruction as a coloured point cloud: export and live viewing.

Counterpart of ``droid_slam_tpu/eval/visualization.py``: each keyframe's
disparities are filtered by multiview consistency (``geom/filters.py``),
back-projected to world points and coloured from the keyframe's image;
``save_ply`` writes an ASCII PLY, ``show`` opens an Open3D window when the
package is installed, and ``run_visualizer`` re-exports the cloud while
tracking runs. Reads the port's ``DepthVideo`` under its lock.
"""

from __future__ import annotations

import traceback

import numpy as np
import torch

from ..geom.filters import depth_filter, iproj_points


def snapshot(video):
    """Copies of the whole buffers of poses and disparities, the intrinsics
    of frame 0, the counter and the images, taken under the video's writer
    lock, so that a viewer thread never reads a half-written window. The
    depth filter sees the whole buffer, as the reference's does: a frame's
    neighbours past the counter are slots not yet written."""
    with video.get_lock():
        t = video.counter
        return dict(counter=t, poses=video.poses.clone(),
                    disps=video.disps.clone(),
                    intrinsics=video.intrinsics[0].clone(),
                    images=list(video.images[:t]))


def frame_colors(images, h, w):
    """Each keyframe's colour at its h x w disparity pixels, RGB uint8
    [n,h,w,3]: the full-resolution BGR image subsampled at [3::8, 3::8]
    (or taken as it is at h x w), zeros where there is no image."""
    out = np.zeros((len(images), h, w, 3), np.uint8)
    for k, img in enumerate(images):
        if img is not None:
            img8 = img[3::8, 3::8] if img.shape[0] == h * 8 else img
            out[k] = img8[..., ::-1]
    return out


def filtered_cloud(poses, disps, intrinsics, images, ix, filter_thresh,
                   min_count=2):
    """The coloured points of frames ``ix`` that at least ``min_count``
    neighbours confirm (the threshold ``filter_thresh`` times the frame's
    mean disparity) and whose disparity is above half the mean of those
    frames'. poses [N,7], disps [N,h,w], intrinsics [4] on one device,
    images the N frames' (or None). Returns (points [P,3] f32, colors
    [P,3] RGB uint8) as numpy, frame by frame."""
    disps_ix = disps[ix]
    thresh = filter_thresh * disps_ix.mean(dim=(1, 2))
    count = depth_filter(poses, disps, intrinsics, ix, thresh)
    pts = iproj_points(poses[ix], disps_ix, intrinsics)
    masks = (count >= min_count) & (disps_ix > 0.5 * disps_ix.mean())
    masks = masks.cpu()
    h, w = disps.shape[-2:]
    colors = frame_colors([images[i] for i in ix.tolist()], h, w)
    return pts.cpu()[masks].numpy(), colors[masks.numpy()]


def reconstruction_point_cloud(video, filter_thresh=0.005, min_count=2,
                               stride=1):
    """The filtered coloured point cloud (``filtered_cloud``) of every
    ``stride``-th keyframe of a DepthVideo."""
    s = snapshot(video)
    ix = torch.arange(0, s["counter"], stride, device=s["disps"].device)
    return filtered_cloud(s["poses"], s["disps"], s["intrinsics"],
                          s["images"], ix, filter_thresh, min_count)


def save_ply(path, points, colors):
    """Write an ASCII PLY point cloud (no external dependency)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        for p, c in zip(points, colors):
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} "
                    f"{int(c[0])} {int(c[1])} {int(c[2])}\n")


def show(points, colors):
    """An Open3D window; raises ImportError without the package."""
    import open3d as o3d
    pcd = o3d.geometry.PointCloud()
    pcd.points = o3d.utility.Vector3dVector(points)
    pcd.colors = o3d.utility.Vector3dVector(colors / 255.0)
    o3d.visualization.draw_geometries([pcd])


def run_visualizer(video, stop_event, period: float = 5.0,
                   out_path: str = "reconstruction_live.ply"):
    """Live reconstruction loop: every ``period`` s, once the video holds 4
    keyframes and one of them changed, rebuild the filtered point cloud
    and show it (Open3D) or write it to ``out_path``, until ``stop_event``
    is set. Run it in a daemon thread:
    ``Thread(target=run_visualizer, args=(video, event))``."""
    try:
        import open3d  # noqa: F401
        has_o3d = True
    except ImportError:
        has_o3d = False

    while not stop_event.is_set():
        with video.get_lock():
            t = video.counter
            changed = t >= 4 and video.dirty[:t].any()
            if changed:
                video.dirty[:t] = False
        if changed:
            try:
                pts, cols = reconstruction_point_cloud(video)
                if has_o3d:
                    show(pts, cols)
                else:
                    save_ply(out_path, pts, cols)
            except Exception:   # the viewer never takes tracking down
                traceback.print_exc()
        stop_event.wait(period)
