"""A saved reconstruction as a point cloud, with the PyTorch/CUDA port.

    python view_reconstruction_torch.py --reconstruction_path R.npz \
        [--ply OUT.ply] [--filter_thresh 0.005] [--device cuda|cpu]

The flags of ``view_reconstruction.py``: reads the ``.npz`` that
``demo_torch.py --reconstruction_path`` writes, keeps the pixels that at
least 2 neighbouring keyframes confirm (``geom/filters.py::depth_filter``)
and whose disparity is above half the mean, and writes them as a PLY with
``--ply`` or shows them in an Open3D window. Full-resolution disparities
(``--upsample``) are taken at the feature pixels [3::8, 3::8]; they are
recognised by their shape, that of the images. Runs on the card unless
``--device cpu``.
"""

import argparse

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reconstruction_path", required=True,
                        help=".npz saved by demo_torch.py "
                             "--reconstruction_path")
    parser.add_argument("--ply", default=None, help="export PLY instead of "
                        "opening a viewer")
    parser.add_argument("--filter_thresh", type=float, default=0.005)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def point_cloud(data, filter_thresh=0.005, device="cuda"):
    """(points [P,3] f32, colors [P,3] RGB uint8) of a saved reconstruction
    (``data``: its arrays by name)."""
    import torch
    from droid_slam_tpu_torch.eval.visualization import filtered_cloud

    images = data["images"]
    disps = data["disps"]
    # full-resolution disparities have the images' shape; the tracker's
    # own are at 1/8 (whatever their sides divide by)
    if disps.shape[1:] == images.shape[1:3]:
        disps = disps[:, 3::8, 3::8]
    t = len(disps)
    as_tensor = lambda a: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a, np.float32), device=device)
    return filtered_cloud(as_tensor(data["poses"]), as_tensor(disps),
                          as_tensor(data["intrinsics"][0]), list(images),
                          torch.arange(t, device=device), filter_thresh)


def main(argv=None):
    args = parse_args(argv)
    from droid_slam_tpu_torch.eval.visualization import save_ply, show
    from droid_slam_tpu_torch.utils.device import require_device

    require_device("view_reconstruction_torch.py", args.device)

    with np.load(args.reconstruction_path) as f:
        data = {k: f[k] for k in f.files}
    points, colors = point_cloud(data, args.filter_thresh, args.device)
    if args.ply:
        save_ply(args.ply, points, colors)
        print(f"wrote {len(points)} points to {args.ply}")
    else:
        show(points, colors)


if __name__ == "__main__":
    main()
