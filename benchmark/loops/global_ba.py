"""Global bundle adjustment passes: ``DroidBackend`` over a video filled with
the traffic's keyframes, as ``terminate()`` runs it at the end of a long
sequence. Each pass proposes proximity edges over all t^2 keyframe pairs
and runs the traffic's global-BA steps; set-up runs one pass (the one that
normalizes the scale), the window the others. The window starts no pass
once the time left is shorter than the last pass took, and ends when its
last pass does.

Before each pass the poses, disparities and damping are copied (a few MB,
on the device); the pass's frame distances and proposed edges are kept.
After the window one pass, drawn from the seed, is computed again by the
plain reference from the state before it."""

from __future__ import annotations

import gc
import time

import numpy as np

from benchmark import checks, harness, timeline
from benchmark.traffic import keyframe_video


def _video(inputs, t, image_size, buffer, device):
    from droid_slam_tpu_torch.state.video import DepthVideo
    import torch
    v = DepthVideo(image_size=tuple(image_size), buffer=buffer,
                   device=device)
    with torch.no_grad():
        v.poses[:t] = inputs["poses"]
        v.disps[:t] = inputs["disps"]
        v.intrinsics[:] = inputs["intrinsics"]
        v.tstamp.copy_(torch.arange(buffer, dtype=torch.float32))
        for name in ("fmaps", "nets", "inps"):
            getattr(v, name)[:t] = inputs[name]
    v.counter = t
    v.dirty[:t] = True
    return v


class _Probe:
    """Patches the port's classes for the window: keeps each pass's frame
    distances and edges, and with ``spans`` times the proposal, the
    distance, the global BA and its BA iterations, synchronised at their
    starts and ends."""

    def __init__(self, sync, spans):
        from droid_slam_tpu_torch.state.graph import FactorGraph
        from droid_slam_tpu_torch.state.video import DepthVideo
        self.sync, self.spans = sync, spans
        self.dist, self.edges = [], []
        self.time = {"proposal": 0.0, "distance": 0.0, "sweep_ba": 0.0,
                     "ba": 0.0}
        self.patches = []
        probe = self

        def keep_dist(orig):
            def f(self, *a, **k):
                out = orig(self, *a, **k)
                probe.dist.append(out)
                return out
            return f

        def keep_edges(orig):
            def f(self, *a, **k):
                out = orig(self, *a, **k)
                probe.edges.append(np.stack([self.ii, self.jj], 1).copy())
                return out
            return f

        self._patch(DepthVideo, "distance", keep_dist, "distance")
        self._patch(FactorGraph, "add_proximity_factors", keep_edges,
                    "proposal")
        self._patch(FactorGraph, "update_lowmem", None, "sweep_ba")
        self._patch(DepthVideo, "ba", None, "ba")

    def _timed(self, orig, key):
        probe = self

        def f(*a, **k):
            probe.sync()
            tic = time.perf_counter()
            with timeline.span(key):
                out = orig(*a, **k)
            probe.sync()
            probe.time[key] += time.perf_counter() - tic
            return out
        return f

    def _patch(self, owner, name, wrap, key):
        orig = getattr(owner, name)
        fn = orig if wrap is None else wrap(orig)
        if self.spans:
            fn = self._timed(fn, key)
        self.patches.append((owner, name, orig))
        setattr(owner, name, fn)

    def close(self):
        for owner, name, orig in reversed(self.patches):
            setattr(owner, name, orig)


def run(cell, seed, seconds, trace, device, t_start, control=False):
    import torch
    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.models import weights as tweights
    from droid_slam_tpu_torch.slam.backend import DroidBackend

    cfg, tr = cell.config, cell.traffic
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else \
        (lambda: None)
    t = tr["keyframes"]
    size = tuple(cfg["image_size"])
    steps = tr["steps_per_pass"]
    stages = {"start_s": time.perf_counter() - t_start}
    mk = lambda: keyframe_video.make(t, size, tr["walk_seed"], seed,
                                     tr["step"], tr["rot_step"], device)
    video = _video(mk(), t, size, cfg["buffer"], device)
    stages["video_s"] = time.perf_counter() - t_start
    params = tweights.load(harness.weights_path(cfg), device)
    backend = DroidBackend(params, video, DroidConfig(
        buffer=cfg["buffer"], image_size=size, beta=cfg["beta"],
        backend_thresh=cfg["backend_thresh"],
        backend_radius=cfg["backend_radius"],
        backend_nms=cfg["backend_nms"]))
    stages["backend_s"] = time.perf_counter() - t_start
    with torch.no_grad():
        for i in range(tr["warm_passes"]):
            backend(steps=steps, normalize=(i == 0))
    sync()
    probe = _Probe(sync, spans=trace)
    setup_s = time.perf_counter() - t_start

    pre, passes, last = [], 0, 0.0
    snap = lambda: (video.poses[:t].clone(), video.disps[:t].clone(),
                    video.damping[:t].clone())
    rec = timeline.Recorder(trace, harness.trace_dir)
    with torch.no_grad():
        rec.start()    # the whole window is traced
        t0 = time.perf_counter()
        while passes == 0 or seconds - (time.perf_counter() - t0) >= last:
            tic = time.perf_counter()
            pre.append(snap())
            with timeline.span("pass"):
                backend(steps=steps, normalize=False)
                sync()
            last = time.perf_counter() - tic
            passes += 1
        window_s = time.perf_counter() - t0
        rec.stop()
    probe.close()
    device_rec = harness.device_record(device, 1)
    pre.append(snap())
    n_steps = passes * steps

    rng = np.random.default_rng([seed, 1])
    k = int(rng.integers(passes))
    data = {"t": t, "pre_poses": pre[k][0], "pre_disps": pre[k][1],
            "pre_damping": pre[k][2], "post_poses": pre[k + 1][0],
            "post_disps": pre[k + 1][1],
            "dist": probe.dist[k], "edges": probe.edges[k]}
    if len(probe.dist) != passes or len(probe.edges) != passes:
        raise RuntimeError(f"{len(probe.dist)} distance calls and "
                           f"{len(probe.edges)} proposals in {passes} "
                           "passes")
    times = dict(probe.time)
    edges_per_pass = [len(e) for e in probe.edges]
    del backend, video, params, probe, pre
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    tic = time.perf_counter()
    readings, ctl = checks.global_ba(cell, data, mk(), device,
                                     control=control)
    check_s = time.perf_counter() - tic

    metrics = {"gba_s_per_step": window_s / n_steps, "setup_s": setup_s}
    info = {"check_s": check_s, "passes": passes, "steps": n_steps,
            "edges": edges_per_pass, "checked_pass": k,
            "setup_stages_s": stages,
            "card": harness.power_limit() if cuda else None}
    out = {"metrics": metrics, "readings": readings, "control": ctl,
           "attempted": n_steps, "failed": 0, "device": device_rec,
           "info": info}
    if trace:
        tl = rec.timeline()
        device_rec.update(busy_s=tl.busy_s, window_s=tl.window_s)
        ctx = {"cell": cell, "device": device_rec, "window_s": window_s,
               "passes": passes, "steps_per_pass": steps,
               "steps": n_steps, "edges": edges_per_pass,
               "spans": times, "timeline": tl, "keyframes": t,
               "image_size": size}
        out["metrics"] = harness.read_metrics(cell, ctx)
        out["breakdown"] = tl.breakdown()
    return out
