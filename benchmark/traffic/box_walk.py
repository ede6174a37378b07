"""A camera walking inside a textured box, the scene of the port's synthetic
evaluation (``droid_slam_tpu_torch/data/synthetic.py``, copied here): a
smooth random walk of fixed step and rotation step, rendered by exact ray
casting; the texture is 3-octave value noise at the 3-D exit point, so
every view is photo-consistent and the poses and depths are exact.

``render_numpy`` is the copy of the port's renderer; ``render_torch``
computes the same frames on the device in batches, for streams of
thousands of frames. Both return uint8 BGR images."""

from __future__ import annotations

import numpy as np

BOX_HALF = 2.0


# ---------------------------------------------------------------------------
# the walk (a copy of the port's random_trajectory and its helpers)
# ---------------------------------------------------------------------------

def _axis_angle_mat(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / (np.linalg.norm(axis) + 1e-12)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(angle) * K
            + (1 - np.cos(angle)) * (K @ K)).astype(np.float32)


def random_trajectory(n_frames, rng, box_half=BOX_HALF, step=0.22,
                      rot_step=0.05):
    """(Rs [N,3,3], ts [N,3]) camera-to-world: a walk whose position moves
    ``step`` a frame (reflected at 0.6 of the box) and whose orientation
    turns by |N(0,1)| * ``rot_step`` about a random axis a frame."""
    A = rng.normal(size=(3, 3))
    Q, _ = np.linalg.qr(A)
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    R = Q.astype(np.float32)
    t = rng.uniform(-0.4, 0.4, size=3).astype(np.float32) * box_half
    Rs, ts = [R], [t.copy()]
    vel = rng.normal(size=3)
    vel *= step / (np.linalg.norm(vel) + 1e-9)
    lim = 0.6 * box_half
    for _ in range(n_frames - 1):
        vel = 0.7 * vel + 0.3 * rng.normal(size=3) * step
        vel *= step / (np.linalg.norm(vel) + 1e-9)
        t = t + vel.astype(np.float32)
        for k in range(3):
            if abs(t[k]) > lim:
                t[k] = np.clip(t[k], -lim, lim)
                vel[k] = -vel[k]
        dR = _axis_angle_mat(rng.normal(size=3),
                             abs(rng.normal()) * rot_step)
        R = (R @ dR).astype(np.float32)
        Rs.append(R)
        ts.append(t.copy())
    return np.stack(Rs), np.stack(ts)


def walk(n_frames, image_size, seed, step, rot_step):
    """The walk, the texture's seed and the intrinsics [fx, fy, cx, cy] =
    [0.8W, 0.8W, W/2, H/2], all from ``seed``, as the port's
    ``synthetic_stream`` draws them."""
    H, W = image_size
    rng = np.random.default_rng(seed)
    scene_seed = int(rng.integers(1, 2 ** 20))
    Rs, ts = random_trajectory(n_frames, rng, BOX_HALF, step, rot_step)
    intr = np.array([0.8 * W, 0.8 * W, W / 2, H / 2], np.float32)
    return Rs, ts, scene_seed, intr


# ---------------------------------------------------------------------------
# the renderer, as the port's numpy code computes it
# ---------------------------------------------------------------------------

def _hash3(ix, iy, iz, seed):
    h = (ix * 374761393 + iy * 668265263 + iz * 2147483647 + seed
         * 981039) & 0x7FFFFFFF
    h = (h ^ (h >> 13)) * 1274126177 & 0x7FFFFFFF
    return ((h ^ (h >> 16)) & 0xFFFFFF).astype(np.float32) / float(0xFFFFFF)


def _value_noise3(p, seed):
    pf = np.floor(p)
    ix, iy, iz = (pf[..., k].astype(np.int64) for k in range(3))
    fx, fy, fz = (p[..., k] - pf[..., k] for k in range(3))
    fx = fx * fx * (3 - 2 * fx)
    fy = fy * fy * (3 - 2 * fy)
    fz = fz * fz * (3 - 2 * fz)
    c = {(dx, dy, dz): _hash3(ix + dx, iy + dy, iz + dz, seed)
         for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)}
    x00 = c[0, 0, 0] + (c[1, 0, 0] - c[0, 0, 0]) * fx
    x10 = c[0, 1, 0] + (c[1, 1, 0] - c[0, 1, 0]) * fx
    x01 = c[0, 0, 1] + (c[1, 0, 1] - c[0, 0, 1]) * fx
    x11 = c[0, 1, 1] + (c[1, 1, 1] - c[0, 1, 1]) * fx
    y0 = x00 + (x10 - x00) * fy
    y1 = x01 + (x11 - x01) * fy
    return y0 + (y1 - y0) * fz


def _texture(points, seed):
    out = np.empty(points.shape[:-1] + (3,), np.float32)
    for c in range(3):
        out[..., c] = (0.55 * _value_noise3(points * 3.1, seed * 7 + c)
                       + 0.3 * _value_noise3(points * 9.7, seed * 13 + 100
                                             + c)
                       + 0.15 * _value_noise3(points * 31.3, seed * 29 + 200
                                              + c))
    return np.clip(out * 255.0, 0, 255)


def render_numpy(R, t, intr, image_size, scene_seed):
    """One view: (uint8 BGR [H,W,3], depth [H,W])."""
    H, W = image_size
    fx, fy, cx, cy = intr
    u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    dc = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], axis=-1)
    dirs = dc @ R.T
    o = t.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        s_axis = (np.copysign(BOX_HALF, dirs) - o) / dirs
    s_axis = np.where(np.abs(dirs) < 1e-9, np.inf, s_axis)
    s = np.min(s_axis, axis=-1)
    img = _texture(o + dirs * s[..., None], scene_seed)
    return img[..., ::-1].astype(np.uint8), s.astype(np.float32)


# ---------------------------------------------------------------------------
# the same on the device
# ---------------------------------------------------------------------------

_A, _B, _C, _S = 374761393, 668265263, 2147483647, 981039


def _hash3_t(lin):
    """``_hash3`` of the lattice point whose linear part
    ix*A + iy*B + iz*C + seed*S is ``lin`` (int64)."""
    h = lin & 0x7FFFFFFF
    h = ((h ^ (h >> 13)) * 1274126177) & 0x7FFFFFFF
    return ((h ^ (h >> 16)) & 0xFFFFFF).float() / float(0xFFFFFF)


def _value_noise3_t(p, seed):
    import torch
    pf = torch.floor(p)
    i = pf.long()
    f = p - pf
    f = f * f * (3 - 2 * f)
    fx, fy, fz = f.unbind(-1)
    # the hash's linear part at the cell's corner; the other corners add
    # constants to it (the same sums, modulo 2^64, as _hash3's)
    lin = (i * torch.tensor([_A, _B, _C], device=p.device)).sum(-1) \
        + seed * _S
    c = {(dx, dy, dz): _hash3_t(lin + (dx * _A + dy * _B + dz * _C))
         for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)}
    x00 = c[0, 0, 0] + (c[1, 0, 0] - c[0, 0, 0]) * fx
    x10 = c[0, 1, 0] + (c[1, 1, 0] - c[0, 1, 0]) * fx
    x01 = c[0, 0, 1] + (c[1, 0, 1] - c[0, 0, 1]) * fx
    x11 = c[0, 1, 1] + (c[1, 1, 1] - c[0, 1, 1]) * fx
    y0 = x00 + (x10 - x00) * fy
    y1 = x01 + (x11 - x01) * fy
    return y0 + (y1 - y0) * fz


def render_torch(Rs, ts, intr, image_size, scene_seed, device, batch=96):
    """Views of every pose, rendered on ``device`` ``batch`` at a time:
    uint8 BGR [N,H,W,3] on the host."""
    import torch
    H, W = image_size
    fx, fy, cx, cy = (float(x) for x in intr)
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32,
                                       device=device),
                          torch.arange(W, dtype=torch.float32,
                                       device=device), indexing="ij")
    dc = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], -1)
    out = np.empty((len(Rs), H, W, 3), np.uint8)
    for b in range(0, len(Rs), batch):
        R = torch.as_tensor(Rs[b:b + batch], device=device)
        o = torch.as_tensor(ts[b:b + batch], device=device)[:, None, None]
        # dirs = dc @ R^T, one product per component, in f32
        dirs = sum(dc[None, ..., k, None] * R[:, None, None, :, k]
                   for k in range(3))
        s_axis = (torch.copysign(torch.full_like(dirs, BOX_HALF), dirs)
                  - o) / dirs
        s_axis = torch.where(dirs.abs() < 1e-9, torch.inf, s_axis)
        pts = o + dirs * s_axis.min(-1).values[..., None]
        img = torch.empty(pts.shape, dtype=torch.float32, device=device)
        for c in range(3):
            img[..., c] = (
                0.55 * _value_noise3_t(pts * 3.1, scene_seed * 7 + c)
                + 0.3 * _value_noise3_t(pts * 9.7, scene_seed * 13 + 100 + c)
                + 0.15 * _value_noise3_t(pts * 31.3,
                                         scene_seed * 29 + 200 + c))
        img = (img * 255.0).clamp(0, 255).flip(-1).to(torch.uint8)
        out[b:b + batch] = img.cpu().numpy()
    return out


def stream(n_frames, image_size, walk_seed, seed, step, rot_step, device):
    """(images uint8 [N,H,W,3] on the host, intrinsics [4]): the walk of
    ``walk_seed``, the same for every run of a traffic mix, so that runs
    do the same work, in a texture drawn from ``seed``."""
    Rs, ts, _, intr = walk(n_frames, image_size, walk_seed, step, rot_step)
    texture = int(np.random.default_rng(seed).integers(1, 2 ** 20))
    return render_torch(Rs, ts, intr, image_size, texture, device), intr
