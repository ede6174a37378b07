"""Global bundle adjustment at the presets' buffer sizes, on the PyTorch port.

The port's counterpart of ``tools/bench_global_ba.py``, with its flags plus
``--device``. It drives the real backend (``DroidBackend``: the proximity
proposal over all t^2 keyframe pairs, the chunked alt-correlation GRU
sweeps and the global BA) on a synthetic video of t keyframes, built from
the same random draws as the JAX tool's, so that the proposal sees the same
poses and disparities. Unlike the JAX tool, which used random weights, it
runs the trained ``checkpoints/r5_006000.npz``, so that the state's health
after several steps means something. Passes of ``--steps`` steps each: the
first normalizes the scale, the later ones do not.

Each global-BA step is timed on the device (synchronised at its BA's
return); the proposal is split into the frame distance, the edge state
(``add_factors``) and the NMS walk, the rest of the proposal. It prints one
JSON line: the median seconds per step after each pass's first step, every
step's time, the stages, the graph, the state's health, the peak device
memory and the card's name and power limit; ``--out`` also writes it to a
file. Runs on the card unless ``--device cpu``.

    python tools/bench_global_ba_torch.py --t 1000 --height 384 --width 512 \
        --steps 2 2
    python tools/bench_global_ba_torch.py --t 24 --height 64 --width 96 \
        --steps 1 1 --device cpu
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from droid_slam_tpu_torch.utils.device import require_device  # noqa: E402

CKPT = os.path.join(ROOT, "checkpoints", "r5_006000.npz")
# the TartanAir evaluation settings of tools/bench_global_ba.py (the tum
# preset's backend settings are the same)
BACKEND = dict(beta=0.3, backend_thresh=20.0, backend_radius=2,
               backend_nms=3)


def synthetic_video(t, image_size, device, seed=0):
    """A ``DepthVideo`` of t keyframes (buffer t+8) as tools/bench_global_ba.py
    builds JAX's: a smooth random walk (``random_trajectory``, step 0.04,
    rotation step 0.01), disparities U(0.8, 1.2), intrinsics
    [0.8w, 0.8w, w/2, h/2] at the feature scale, then features N(0, 1) and
    GRU states and contexts N(0, 0.1^2), all drawn from one
    ``np.random.default_rng(seed)`` in JAX's order and layout (channels
    last), then moved to the port's (channels first)."""
    import torch
    from droid_slam_tpu_torch.data.synthetic import (poses_c2w_from_mats,
                                                     random_trajectory)
    from droid_slam_tpu_torch.lie import se3
    from droid_slam_tpu_torch.state.video import DepthVideo

    H, W = image_size
    h, w = H // 8, W // 8
    B = t + 8
    rng = np.random.default_rng(seed)
    video = DepthVideo(image_size=(H, W), buffer=B, device=device)
    Rs, ts = random_trajectory(t, rng, step=0.04, rot_step=0.01)
    with torch.no_grad():
        video.poses[:t] = se3.inv(
            torch.as_tensor(poses_c2w_from_mats(Rs, ts))).to(device)
        video.tstamp.copy_(torch.arange(B, dtype=torch.float32))
        video.disps.copy_(torch.as_tensor(
            rng.uniform(0.8, 1.2, size=(B, h, w)).astype(np.float32)))
        video.intrinsics.copy_(torch.tensor(
            [0.8 * w, 0.8 * w, w / 2, h / 2]).expand(B, 4))
        # one field at a time, cast to bf16 on the host: the f64 draws of
        # a t=1000 384x512 field alone take 3.2 GB
        for buf, scale in ((video.fmaps, 1.0), (video.nets, 0.1),
                           (video.inps, 0.1)):
            nhwc = buf.shape[:-3] + buf.shape[-2:] + buf.shape[-3:-2]
            x = rng.normal(size=nhwc).astype(np.float32)
            if scale != 1.0:
                x *= np.float32(scale)
            x = torch.from_numpy(x).to(torch.bfloat16).movedim(-1, -3)
            buf.copy_(x)
            del x
    video.counter = t
    video.dirty[:t] = True
    return video


def smi():
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()[:200]}"


class _Probe:
    """Timers and counters around the port's own functions, patched from
    here for the duration of a run (the port carries no hooks): the device
    is synchronised at each timed function's start and end, so each span
    holds its own device work."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.spans = {}
        self.calls = {}
        self.step_times = []
        self.chunk_sizes = []
        self._step_start = None

    def _sync(self):
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    def wrap(self, owner, name, key, before=None, after=None):
        """Replace ``owner.name`` by a timed copy; returns the original.
        ``before(tic)`` runs after the opening synchronisation, ``after(now,
        *args)`` after the closing one."""
        orig = getattr(owner, name)

        def timed(*a, **k):
            self._sync()
            tic = time.perf_counter()
            if before is not None:
                before(tic)
            out = orig(*a, **k)
            self._sync()
            now = time.perf_counter()
            self.spans[key] = self.spans.get(key, 0.0) + (now - tic)
            self.calls[key] = self.calls.get(key, 0) + 1
            if after is not None:
                after(now, *a, **k)
            return out

        setattr(owner, name, timed)
        return orig

    def step_start(self, now):
        self._step_start = now

    def ba_done(self, now, *a, **k):
        self.step_times.append(now - self._step_start)
        self._step_start = now

    def chunk(self, now, graph, fpyr, weights, ch):
        self.chunk_sizes.append(len(ch.sel))


def run(t, image_size, steps, device, video=None):
    """``DroidBackend`` passes of ``steps`` steps on ``synthetic_video``
    (or ``video``) with the trained weights and the TartanAir evaluation
    settings (``BACKEND``); the result record (see the module's
    docstring)."""
    import torch
    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.models import weights as tweights
    from droid_slam_tpu_torch.ops import frame_distance_cuda
    from droid_slam_tpu_torch.slam.backend import DroidBackend
    from droid_slam_tpu_torch.state.graph import FactorGraph
    from droid_slam_tpu_torch.state.video import DepthVideo

    device = torch.device(device)
    H, W = image_size
    if not os.path.exists(CKPT):
        raise SystemExit(f"needs the trained checkpoint {CKPT}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tic = time.perf_counter()
    if video is None:
        video = synthetic_video(t, image_size, device)
    params = tweights.load(CKPT, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    stages = {"setup_s": time.perf_counter() - tic}

    backend = DroidBackend(params, video, DroidConfig(
        buffer=video.buffer, image_size=(H, W), **BACKEND))

    probe = _Probe(device)
    # a global-BA step starts where update_lowmem starts or the previous
    # step's BA returned, and ends where its BA returns
    patches = [
        (DepthVideo, "distance", "distance", None, None),
        (frame_distance_cuda, "frame_distance", "frame_distance", None,
         None),
        (FactorGraph, "add_factors", "add_factors", None, None),
        (FactorGraph, "add_proximity_factors", "proposal", None, None),
        (FactorGraph, "update_lowmem", "update_lowmem", probe.step_start,
         None),
        (DepthVideo, "ba", "ba", None, probe.ba_done),
        (FactorGraph, "_lowmem_chunk", "sweep_chunks", None, probe.chunk),
    ]
    originals = []
    try:
        for owner, name, key, before, after in patches:
            originals.append((owner, name,
                              probe.wrap(owner, name, key, before, after)))
        passes = []
        for i, n in enumerate(steps):
            before = dict(probe.spans), dict(probe.calls)
            n_steps, n_sizes = len(probe.step_times), len(probe.chunk_sizes)
            tic = time.perf_counter()
            edges = backend(steps=n, normalize=(i == 0))
            if device.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - tic
            span = {k: v - before[0].get(k, 0.0)
                    for k, v in probe.spans.items()}
            calls = {k: v - before[1].get(k, 0)
                     for k, v in probe.calls.items()}
            sizes = probe.chunk_sizes[n_sizes:]
            n_chunks = len(sizes) // n if n else 0
            passes.append(dict(
                steps=n, normalize=(i == 0), wall_s=wall, edges=edges,
                distance_s=span.get("distance", 0.0),
                add_factors_s=span.get("add_factors", 0.0),
                nms_walk_s=(span.get("proposal", 0.0)
                            - span.get("distance", 0.0)
                            - span.get("add_factors", 0.0)),
                global_ba_s=span.get("update_lowmem", 0.0),
                ba_s=span.get("ba", 0.0),
                sweep_s=(span.get("update_lowmem", 0.0)
                         - span.get("ba", 0.0)),
                step_times_s=probe.step_times[n_steps:],
                dist_chunks=calls.get("frame_distance", 0),
                n_chunks=n_chunks, max_chunk=max(sizes, default=0)))
    finally:
        for owner, name, orig in reversed(originals):
            setattr(owner, name, orig)

    poses = video.poses[:t].cpu().numpy()
    disps = video.disps[:t].cpu().numpy()
    qn = np.linalg.norm(poses[:, 3:], axis=-1)
    health = {
        "poses_finite": bool(np.isfinite(poses).all()),
        "disps_finite_pos": bool(np.isfinite(disps).all()
                                 and (disps > 0).all()),
        "quat_norm_max_err": float(np.abs(qn - 1.0).max()),
    }
    # each pass's first step also builds the feature pyramid and the BA's
    # plan; the steady state is the median of the others
    warm = [s for p in passes for s in p["step_times_s"][1:]]
    every = [s for p in passes for s in p["step_times_s"]]
    for i, p in enumerate(passes):
        stages[f"pass{i}"] = {k: p[k] for k in (
            "steps", "normalize", "wall_s", "edges", "dist_chunks",
            "distance_s", "add_factors_s", "nms_walk_s", "global_ba_s",
            "sweep_s", "ba_s")}
    last = passes[-1]
    memory = {"peak_allocated_gib": None, "peak_reserved_gib": None}
    if device.type == "cuda":
        memory = {"peak_allocated_gib": torch.cuda.max_memory_allocated()
                  / 2 ** 30,
                  "peak_reserved_gib": torch.cuda.max_memory_reserved()
                  / 2 ** 30}
    return {
        "metric": "global_ba_step_time_t%d_%dx%d" % (t, H, W),
        "value": float(np.median(warm or every)) if every else None,
        "unit": "s/step",
        "t_keyframes": t,
        "n_steps_total": len(every),
        "step_times_s": every,
        "stages": stages,
        "graph": {"n_edges": last["edges"],
                  "n_chunks": last["n_chunks"],
                  "max_chunk": last["max_chunk"],
                  "dist_chunks": last["dist_chunks"]},
        "health": health,
        "memory": memory,
        "weights": os.path.relpath(CKPT, ROOT),
        "device": ({"name": torch.cuda.get_device_name(device),
                    "smi": smi()} if device.type == "cuda"
                   else {"name": "cpu", "smi": None}),
    }


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t", type=int, default=1000)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--steps", type=int, nargs="+", default=[7, 12])
    ap.add_argument("--out", default=None,
                    help="also write the record to this JSON file")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run on the "
                         "CPU)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    require_device("bench_global_ba_torch.py", args.device)
    result = run(args.t, (args.height, args.width), args.steps, args.device)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
