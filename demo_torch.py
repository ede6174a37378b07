"""SLAM on a directory of images with the PyTorch/CUDA port.

    python demo_torch.py --imagedir DIR --calib calib/eth.txt \
        [--asynchronous] [--device cuda|cpu] [--trajectory_path T.txt] \
        [--reconstruction_path R.npz] [--screenshot S.png]

The flags and flow of ``demo.py``: intrinsics from a calibration file
(fx fy cx cy [distortion]), each image undistorted when the file has
distortion terms and resized to about 384x512 pixels with sides a multiple
of 8, every ``--stride``-th image tracked, then ``terminate()`` (the global
BA and the trajectory filler; with ``--asynchronous`` the backend runs
beside tracking, in a process when ``DROID_ASYNC_PROCESS=1``). Writes the
camera-to-world trajectory [T,7] as text and, with
``--reconstruction_path``, the keyframes as an ``.npz`` with ``demo.py``'s
fields, and with ``--screenshot`` a PNG of the reconstruction (point cloud
and camera frusta) from the offscreen rasteriser. Runs on the card unless
``--device cpu``.
"""

import argparse
import glob
import os

import numpy as np

# each image is resized to about this many pixels, sides a multiple of 8
TARGET_AREA = 384 * 512


def image_stream(imagedir, calib, stride):
    """Yields (t, image [H,W,3] BGR uint8, intrinsics [4])."""
    import cv2

    calib = np.loadtxt(calib, delimiter=" ")
    fx, fy, cx, cy = calib[:4]
    K = np.eye(3)
    K[0, 0], K[0, 2], K[1, 1], K[1, 2] = fx, cx, fy, cy

    paths = sorted(glob.glob(os.path.join(imagedir, "*.png"))
                   + glob.glob(os.path.join(imagedir, "*.jpg")))

    for t, imfile in enumerate(paths[::stride]):
        image = cv2.imread(imfile)
        if len(calib) > 4:
            image = cv2.undistort(image, K, calib[4:])

        h0, w0 = image.shape[:2]
        h1 = int(h0 * np.sqrt(TARGET_AREA / (h0 * w0)))
        w1 = int(w0 * np.sqrt(TARGET_AREA / (h0 * w0)))
        image = cv2.resize(image, (w1, h1))
        image = image[: h1 - h1 % 8, : w1 - w1 % 8]

        intrinsics = np.array([fx, fy, cx, cy], np.float32)
        intrinsics[0::2] *= w1 / w0
        intrinsics[1::2] *= h1 / h0
        yield t, image, intrinsics


def save_reconstruction(droid, path):
    """The tracker's keyframes: timestamps, world-to-camera poses,
    disparities (full resolution with ``upsample``), intrinsics at 1/8
    scale and images."""
    v = droid.video
    t = v.counter
    disps = v.disps_up if droid.config.upsample else v.disps
    np.savez(
        path,
        tstamps=v.tstamp[:t].cpu().numpy(),
        poses=v.poses[:t].cpu().numpy(),
        disps=disps[:t].cpu().numpy(),
        intrinsics=v.intrinsics[:t].cpu().numpy(),
        images=np.stack(v.images[:t], 0),
    )


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--imagedir", required=True)
    parser.add_argument("--calib", required=True)
    parser.add_argument("--weights", default=None)
    parser.add_argument("--buffer", type=int, default=512)
    parser.add_argument("--image_size", default=[240, 320], type=int,
                        nargs="+")
    parser.add_argument("--filter_thresh", type=float, default=2.4)
    parser.add_argument("--warmup", type=int, default=8)
    parser.add_argument("--keyframe_thresh", type=float, default=4.0)
    parser.add_argument("--frontend_thresh", type=float, default=16.0)
    parser.add_argument("--frontend_window", type=int, default=25)
    parser.add_argument("--frontend_radius", type=int, default=2)
    parser.add_argument("--frontend_nms", type=int, default=1)
    parser.add_argument("--backend_thresh", type=float, default=22.0)
    parser.add_argument("--backend_radius", type=int, default=2)
    parser.add_argument("--backend_nms", type=int, default=3)
    parser.add_argument("--beta", type=float, default=0.3)
    parser.add_argument("--stride", type=int, default=1)
    parser.add_argument("--upsample", action="store_true")
    parser.add_argument("--backend_steps", type=int, nargs="*",
                        default=[7, 12])
    parser.add_argument("--asynchronous", action="store_true",
                        help="run the global BA beside tracking (DroidAsync; "
                             "set DROID_ASYNC_PROCESS=1 for the backend in "
                             "a process of its own)")
    parser.add_argument("--reconstruction_path", default=None)
    parser.add_argument("--trajectory_path", default="trajectory.txt")
    parser.add_argument("--disable_vis", action="store_true")
    parser.add_argument("--screenshot", default=None,
                        help="render the final reconstruction (point cloud "
                             "+ camera frusta) to this PNG with the "
                             "offscreen software rasteriser (no display "
                             "needed)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.slam import make_droid

    droid = None
    for t, image, intrinsics in image_stream(args.imagedir, args.calib,
                                             args.stride):
        if droid is None:
            cfg = DroidConfig(
                buffer=args.buffer, image_size=tuple(image.shape[:2]),
                filter_thresh=args.filter_thresh, warmup=args.warmup,
                keyframe_thresh=args.keyframe_thresh,
                frontend_thresh=args.frontend_thresh,
                frontend_window=args.frontend_window,
                frontend_radius=args.frontend_radius,
                frontend_nms=args.frontend_nms,
                backend_thresh=args.backend_thresh,
                backend_radius=args.backend_radius,
                backend_nms=args.backend_nms, beta=args.beta,
                upsample=args.upsample, weights=args.weights,
                asynchronous=args.asynchronous)
            droid = make_droid(cfg, device=args.device)
        droid.track(t, image, intrinsics=intrinsics)
    if droid is None:
        raise SystemExit(f"no .png or .jpg images in {args.imagedir}")

    stream = image_stream(args.imagedir, args.calib, args.stride)
    if args.asynchronous:
        # the asynchronous facades run their own backend schedule
        traj = droid.terminate(stream)
    else:
        traj = droid.terminate(stream,
                               backend_steps=tuple(args.backend_steps))
    np.savetxt(args.trajectory_path, traj)
    print(f"saved trajectory [{traj.shape[0]},7] to {args.trajectory_path}")

    if args.reconstruction_path:
        save_reconstruction(droid, args.reconstruction_path)
        print(f"saved reconstruction to {args.reconstruction_path}")

    if args.screenshot:
        from droid_slam_tpu_torch.eval.viewer import save_screenshot
        # the asynchronous facades' backend video holds the final poses
        if save_screenshot(args.screenshot, droid.video,
                           getattr(droid, "video2", None)):
            print(f"saved reconstruction render to {args.screenshot}")


if __name__ == "__main__":
    main()
