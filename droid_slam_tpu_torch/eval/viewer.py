"""Reconstruction viewer: the scene, an offscreen rasteriser, and a window.

Counterpart of ``droid_slam_tpu/eval/viewer.py``, in two layers:

  * a numpy scene core: camera frustum wireframes, orbit-camera and
    projection matrices, the merge of the asynchronous facades' two videos,
    ``build_scene`` assembling point / colour / alpha / camera-segment
    buffers from DepthVideo state (the depth filter and the back-projection
    run on the video's device), the offscreen software rasteriser
    ``render_offscreen`` and ``save_screenshot``, which writes a PNG with
    the standard library alone;
  * a thin moderngl presentation layer (``InteractiveViewer``), which needs
    the optional ``moderngl`` + ``moderngl_window`` packages;
    ``launch_viewer`` falls back to the polling PLY/Open3D visualiser
    (``eval/visualization.py``) without them.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

from ..geom.filters import depth_filter, iproj_points
from ..lie import se3
from ..slam.align import align_pose_fragments
from .visualization import frame_colors


# ---------------------------------------------------------------------------
# Camera glyph
# ---------------------------------------------------------------------------

def frustum_segments(scale: float = 0.05, aspect: float = 1.5):
    """Wireframe camera glyph as an [S, 3] array of line-segment endpoints
    (consecutive pairs): apex->corner rays, image-plane rectangle, and an
    up-direction tick."""
    z = 1.5 * scale
    x = aspect * scale
    y = scale
    apex = np.zeros(3, np.float32)
    corners = np.array([[-x, -y, z], [x, -y, z], [x, y, z], [-x, y, z]],
                       np.float32)
    segs = []
    for c in corners:
        segs += [apex, c]
    for a, b in zip(corners, np.roll(corners, -1, axis=0)):
        segs += [a, b]
    # up tick on the top edge
    segs += [np.array([-0.4 * x, y, z], np.float32),
             np.array([0.0, 1.25 * y, z], np.float32)]
    segs += [np.array([0.0, 1.25 * y, z], np.float32),
             np.array([0.4 * x, y, z], np.float32)]
    return np.stack(segs, axis=0)


def transform_segments(poses_w2c, segments):
    """Place one camera glyph per keyframe: world_pt = G^-1 * p for each
    world-to-camera pose. poses: [n,7] ([t,q]); segments: [S,3]. Returns
    [n*S, 3] numpy."""
    G_c2w = se3.inv(torch.as_tensor(np.asarray(poses_w2c, np.float32)))
    pts = se3.act3(G_c2w[:, None, :],
                   torch.as_tensor(np.asarray(segments, np.float32))[None])
    return pts.reshape(-1, 3).numpy()


# ---------------------------------------------------------------------------
# Orbit camera (counterpart of visualizer/camera.py's OrbitDragCameraWindow)
# ---------------------------------------------------------------------------

@dataclass
class OrbitCamera:
    """Spherical-orbit camera around a target point."""

    target: np.ndarray = field(default_factory=lambda: np.zeros(3))
    radius: float = 4.0
    yaw: float = 0.0        # radians around +y
    pitch: float = -0.4     # radians above the xz plane
    sensitivity: float = 0.005

    @property
    def eye(self):
        cp = np.cos(self.pitch)
        offset = np.array([cp * np.sin(self.yaw), np.sin(self.pitch),
                           cp * np.cos(self.yaw)])
        return self.target + self.radius * offset

    def rotate(self, dx: float, dy: float):
        self.yaw -= self.sensitivity * dx
        self.pitch = float(np.clip(self.pitch - self.sensitivity * dy,
                                   -1.55, 1.55))

    def zoom(self, steps: float):
        self.radius = float(np.clip(self.radius * (0.9 ** steps), 0.05, 500))

    def pan(self, dx: float, dy: float):
        view = self.view_matrix()
        right, up = view[0, :3], view[1, :3]
        self.target = self.target + self.sensitivity * self.radius * (
            -dx * right + dy * up)

    def view_matrix(self):
        """Right-handed look-at view matrix [4,4]."""
        fwd = self.target - self.eye
        fwd = fwd / np.linalg.norm(fwd)
        world_up = np.array([0.0, 1.0, 0.0])
        if abs(fwd @ world_up) > 0.999:
            world_up = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, world_up)
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        m = np.eye(4, dtype=np.float32)
        m[0, :3], m[1, :3], m[2, :3] = right, up, -fwd
        m[:3, 3] = -m[:3, :3] @ self.eye
        return m


def perspective_matrix(fov_deg=60.0, aspect=16 / 9, near=0.1, far=100.0):
    """OpenGL-convention perspective projection [4,4]."""
    f = 1.0 / np.tan(np.radians(fov_deg) / 2)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


# ---------------------------------------------------------------------------
# The asynchronous facades' two videos
# ---------------------------------------------------------------------------

def _frames(video, t):
    """Copies of poses and disparities [0, t) under the video's lock."""
    with video.get_lock():
        return video.poses[:t].clone(), video.disps[:t].clone()


def merge_videos(video_front, video_back, overlap: int = 16):
    """Combine the tracker's video with the backend's (``video2`` of the
    asynchronous facades) into one (poses, disps) pair of numpy arrays:
    the backend's frames are authoritative; the tracker's frames past them
    are aligned into the backend's frame through the last ``overlap``
    shared keyframes (``slam/align.py``)."""
    t1 = video_front.counter
    t2 = 0 if video_back is None else video_back.counter
    poses_f, disps_f = _frames(video_front, t1)
    if t2 <= 0:
        return poses_f.cpu().numpy(), disps_f.cpu().numpy()
    poses_b, disps_b = _frames(video_back, t2)
    if t2 >= t1:
        return poses_b.cpu().numpy(), disps_b.cpu().numpy()

    poses_f, disps_f = poses_f.to(poses_b.device), disps_f.to(poses_b.device)
    lo = max(0, t2 - overlap)
    dG, s = align_pose_fragments(poses_f[lo:t2], poses_b[lo:t2])
    tail = poses_f[t2:t1].clone()
    tail[:, :3] *= s
    tail = se3.mul(dG, tail)

    poses = torch.cat([poses_b, tail], dim=0)
    disps = torch.cat([disps_b, disps_f[t2:t1] / s], dim=0)
    return poses.cpu().numpy(), disps.cpu().numpy()


# ---------------------------------------------------------------------------
# Scene assembly
# ---------------------------------------------------------------------------

@dataclass
class ViewerScene:
    points: np.ndarray        # [M,3] f32 world points
    colors: np.ndarray        # [M,3] f32 in [0,1]
    alpha: np.ndarray         # [M] f32, 0 = hidden
    cam_segments: np.ndarray  # [t*S,3] f32 line-segment endpoints


def build_scene(video, video_back=None, filter_thresh: float = 0.02,
                min_count: int = 2) -> ViewerScene | None:
    """Render buffers from live video state: every keyframe's points with
    an alpha of 1 where at least ``min_count`` neighbours confirm them and
    their disparity is above a quarter of the mean, and one camera glyph
    per keyframe. None below 4 keyframes."""
    t = video.counter
    if t < 4:
        return None
    poses, disps = merge_videos(video, video_back)
    with video.get_lock():
        intr = video.intrinsics[0].clone()
        images = list(video.images[:len(poses)])
    dev = intr.device
    poses_t = torch.as_tensor(poses, device=dev)
    disps_t = torch.as_tensor(disps, device=dev)
    n = len(poses)
    thresh = filter_thresh * disps_t.mean(dim=(1, 2))
    counts = depth_filter(poses_t, disps_t, intr,
                          torch.arange(n, device=dev), thresh)
    pts = iproj_points(poses_t, disps_t, intr).reshape(-1, 3).cpu().numpy()
    mask = ((counts >= min_count) & (disps_t > 0.25 * disps_t.mean())).cpu()

    h, w = disps.shape[-2:]
    colors = frame_colors(images, h, w).astype(np.float32) / 255.0
    return ViewerScene(
        points=pts.astype(np.float32),
        colors=colors.reshape(-1, 3),
        alpha=mask.reshape(-1).numpy().astype(np.float32),
        cam_segments=transform_segments(poses, frustum_segments())
        .astype(np.float32),
    )


# ---------------------------------------------------------------------------
# Offscreen software renderer
# ---------------------------------------------------------------------------

def _mvp_transform(mvp, pts):
    """Clip-space transform + perspective divide: [N,3] -> NDC [N,3] plus a
    front-of-camera mask (w > near plane). Same math the GL vertex shaders
    above run (`gl_Position = mvp * vec4(pos, 1)`)."""
    clip = pts @ mvp[:3, :3].T + mvp[:3, 3]
    wc = pts @ mvp[3, :3] + mvp[3, 3]
    ok = wc > 1e-6
    ndc = clip / np.where(ok, wc, 1.0)[:, None]
    return ndc, ok


def render_offscreen(scene: ViewerScene, camera: OrbitCamera | None = None,
                     size=(480, 640), fov_deg=60.0,
                     background=(0.09, 0.09, 0.10)):
    """Rasterize a ViewerScene to an RGB uint8 image [H,W,3] without any GL
    context: the same MVP pipeline as the moderngl layer (view matrix ->
    perspective -> NDC -> viewport), z-buffered point splatting with the
    alpha<=0 discard, and white camera-frustum wireframes drawn by segment
    sampling. This is the presentation path used headless (demo
    --disable_vis screenshots, tests) where the reference requires an X11/
    EGL context (droid_visualizer.py:70-252)."""
    H, W = size
    if camera is None:
        camera = OrbitCamera()
        vis = scene.points[scene.alpha > 0]
        if len(vis):
            center = np.median(vis, axis=0)
            camera.target = center.astype(np.float64)
            spread = np.quantile(np.linalg.norm(vis - center, axis=1), 0.9)
            camera.radius = float(max(3.0 * spread, 0.5))
    mvp = perspective_matrix(fov_deg, W / H).astype(np.float64) \
        @ camera.view_matrix().astype(np.float64)

    img = np.empty((H, W, 3), np.float32)
    img[:] = np.asarray(background, np.float32)
    zbuf = np.full((H, W), np.inf, np.float32)

    # --- points (z-buffered splat; alpha <= 0 discarded as in _POINT_FS) ---
    keep = scene.alpha > 0
    pts, cols = scene.points[keep], scene.colors[keep]
    if len(pts):
        ndc, ok = _mvp_transform(mvp, pts.astype(np.float64))
        inside = ok & (np.abs(ndc[:, 0]) < 1) & (np.abs(ndc[:, 1]) < 1) \
            & (np.abs(ndc[:, 2]) < 1)
        ndc, cols = ndc[inside], cols[inside]
        px = ((ndc[:, 0] + 1) * 0.5 * (W - 1)).astype(np.int64)
        py = ((1 - ndc[:, 1]) * 0.5 * (H - 1)).astype(np.int64)
        depth = ndc[:, 2].astype(np.float32)
        # z-buffer via sort: draw far-to-near so the last write wins
        order = np.argsort(-depth)
        flat = py[order] * W + px[order]
        img.reshape(-1, 3)[flat] = cols[order]
        zbuf.reshape(-1)[flat] = depth[order]

    # --- camera wireframes (segment sampling, drawn over closer z only) ---
    segs = scene.cam_segments.reshape(-1, 2, 3)
    if len(segs):
        ndc_a, ok_a = _mvp_transform(mvp, segs[:, 0].astype(np.float64))
        ndc_b, ok_b = _mvp_transform(mvp, segs[:, 1].astype(np.float64))
        ok = ok_a & ok_b
        ts = np.linspace(0.0, 1.0, 24)[None, :, None]
        samp = ndc_a[ok][:, None, :] * (1 - ts) + ndc_b[ok][:, None, :] * ts
        samp = samp.reshape(-1, 3)
        inside = (np.abs(samp[:, 0]) < 1) & (np.abs(samp[:, 1]) < 1) \
            & (np.abs(samp[:, 2]) < 1)
        samp = samp[inside]
        px = ((samp[:, 0] + 1) * 0.5 * (W - 1)).astype(np.int64)
        py = ((1 - samp[:, 1]) * 0.5 * (H - 1)).astype(np.int64)
        depth = samp[:, 2].astype(np.float32)
        front = depth <= zbuf[py, px] + 1e-6
        img[py[front], px[front]] = (0.92, 0.92, 0.92)

    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def png_bytes(img):
    """An RGB uint8 image [H,W,3] as the bytes of an 8-bit truecolour PNG
    (zlib and struct: the standard library alone)."""
    img = np.ascontiguousarray(img, np.uint8)
    H, W, _ = img.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8),     # filter: none
                           img.reshape(H, W * 3)], axis=1)

    def chunk(kind, data):
        body = kind + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_screenshot(path, video, video_back=None, **kw):
    """Build the scene from live DepthVideo state, render it offscreen and
    write it to ``path`` as a PNG. False (and no file) below 4 keyframes."""
    scene = build_scene(video, video_back)
    if scene is None:
        return False
    img = render_offscreen(scene, **kw)
    with open(path, "wb") as f:
        f.write(png_bytes(img))
    return True


# ---------------------------------------------------------------------------
# moderngl presentation layer (optional dependency)
# ---------------------------------------------------------------------------

_POINT_VS = """
#version 330
in vec3 in_pos; in vec3 in_rgb; in float in_a;
uniform mat4 mvp;
out vec3 rgb; out float a;
void main() { gl_Position = mvp * vec4(in_pos, 1.0); rgb = in_rgb; a = in_a; }
"""
_POINT_FS = """
#version 330
in vec3 rgb; in float a; out vec4 frag;
void main() { if (a <= 0.0) discard; frag = vec4(rgb, a); }
"""
_LINE_VS = """
#version 330
in vec3 in_pos; uniform mat4 mvp;
void main() { gl_Position = mvp * vec4(in_pos, 1.0); }
"""
_LINE_FS = """
#version 330
uniform vec3 rgb; out vec4 frag;
void main() { frag = vec4(rgb, 1.0); }
"""


class InteractiveViewer:
    """Windowed viewer. Requires `moderngl` + a window backend (glfw via
    moderngl_window); construct then call run(). Mouse: drag = orbit,
    right-drag = pan, wheel = zoom."""

    def __init__(self, video, video_back=None, refresh_every: int = 5,
                 size=(1280, 720)):
        self.video = video
        self.video_back = video_back
        self.refresh_every = refresh_every
        self.size = size
        self.camera = OrbitCamera()

    # -- GL plumbing --------------------------------------------------------

    def _init_gl(self):
        import moderngl
        import moderngl_window

        self._mgl = moderngl
        self._wnd = moderngl_window.create_window_from_settings()
        self.ctx = self._wnd.ctx
        self.point_prog = self.ctx.program(vertex_shader=_POINT_VS,
                                           fragment_shader=_POINT_FS)
        self.line_prog = self.ctx.program(vertex_shader=_LINE_VS,
                                          fragment_shader=_LINE_FS)
        n = video_cap = self.video.buffer
        h, w = self.video.h, self.video.w
        m = video_cap * h * w
        self.pts_buf = self.ctx.buffer(reserve=m * 12)
        self.rgb_buf = self.ctx.buffer(reserve=m * 12)
        self.a_buf = self.ctx.buffer(reserve=m * 4)
        self.cam_buf = self.ctx.buffer(
            reserve=n * len(frustum_segments()) * 12)
        self.points_vao = self.ctx.vertex_array(
            self.point_prog, [(self.pts_buf, "3f", "in_pos"),
                              (self.rgb_buf, "3f", "in_rgb"),
                              (self.a_buf, "1f", "in_a")])
        self.cams_vao = self.ctx.vertex_array(
            self.line_prog, [(self.cam_buf, "3f", "in_pos")])
        self._n_points = 0
        self._n_cam_verts = 0
        self._wire_input()

    def _wire_input(self):
        wnd = self._wnd

        def on_drag(x, y, dx, dy):
            if wnd.mouse_states.left:
                self.camera.rotate(dx, dy)
            elif wnd.mouse_states.right:
                self.camera.pan(dx, dy)

        def on_scroll(dx, dy):
            self.camera.zoom(dy)

        wnd.mouse_drag_event_func = on_drag
        wnd.mouse_scroll_event_func = on_scroll

    def _refresh_scene(self):
        scene = build_scene(self.video, self.video_back)
        if scene is None:
            return
        self.pts_buf.write(scene.points.tobytes(), offset=0)
        self.rgb_buf.write(scene.colors.tobytes(), offset=0)
        self.a_buf.write(scene.alpha.tobytes(), offset=0)
        self.cam_buf.write(scene.cam_segments.tobytes(), offset=0)
        self._n_points = len(scene.points)
        self._n_cam_verts = len(scene.cam_segments)

    def _mvp(self):
        aspect = self.size[0] / self.size[1]
        return (perspective_matrix(aspect=aspect) @
                self.camera.view_matrix()).T.astype(np.float32)

    def run(self):
        self._init_gl()
        frame = 0
        while not self._wnd.is_closing:
            if frame % self.refresh_every == 0:
                self._refresh_scene()
            self.ctx.clear(1.0, 1.0, 1.0)
            self.ctx.enable(self._mgl.DEPTH_TEST)
            mvp = self._mvp().tobytes()
            self.point_prog["mvp"].write(mvp)
            self.line_prog["mvp"].write(mvp)
            self.line_prog["rgb"].value = (0.0, 0.0, 0.0)
            if self._n_points:
                self.points_vao.render(mode=self._mgl.POINTS,
                                       vertices=self._n_points)
            if self._n_cam_verts:
                self.cams_vao.render(mode=self._mgl.LINES,
                                     vertices=self._n_cam_verts)
            self._wnd.swap_buffers()
            frame += 1


def launch_viewer(video, video_back=None, stop_event=None):
    """Open the interactive viewer if a GL stack is installed, else fall
    back to the polling PLY/Open3D visualiser."""
    try:
        import moderngl  # noqa: F401
        import moderngl_window  # noqa: F401
    except Exception:
        from .visualization import run_visualizer
        import threading
        stop_event = stop_event or threading.Event()
        return run_visualizer(video, stop_event)
    InteractiveViewer(video, video_back).run()
