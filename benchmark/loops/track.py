"""Closed-loop tracking: ``Droid.track()`` on one frame after another of the
box walk, each call starting when the previous one returns, as DROID-SLAM's
demo and evaluation scripts replay a sequence.

The walk is the traffic's (``walk_seed``); ``--seed`` draws the scene's
texture. Set-up renders the stream on the device into host memory, as
many frames as ``STREAM_FPS`` frames a second over the window and the
warm-up take, builds the tracker with the configuration's weights and
tracks ``WARMUP_FRAMES`` frames on the frame path (after the
initialization: the frame programs' first captures). The window then
tracks the following frames for the given seconds; a tracker faster than
the stream, or a keyframe buffer shorter than it, fails the run.

What the window produced is checked afterwards against the plain
reference: the keyframe rows written in the window (the encoders and the
keyframe write), the admission delta of a sample of frames (the encoders,
the correlation lookup and the update operator), and the whole update of a
sample of frames (the update operator with its lookups and damping, the
windowed bundle adjustment and the motion model), followed from the
tracker's own state before the frame: the frame program is wrapped from
outside, the device synchronised and the state copied before it, the
result copied after it; the copying is taken out of the window's time.

With ``--trace 1`` the profiler records the last ``TRACE_SECONDS`` of the
window, in the steady state (reading a longer trace would outlast the
run's time limit); the device's metrics are taken over that part, the
counters over the whole window."""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np

from benchmark import checks, harness, timeline
from benchmark.traffic import box_walk

# frames tracked on the frame path before the window (its first captures)
WARMUP_FRAMES = 48
# the stream's frames a second of window: about 3.5 times the fastest rate
# measured so far, so that a faster tracker still finds its frames
STREAM_FPS = 60
# frames the initialization and the warm-up may take at most
WARMUP_LIMIT = 4 * WARMUP_FRAMES
# the check's samples: keyframe rows written in the window, admission
# deltas, frames whose whole update is followed (their limits in
# ``limits/`` were set at these sizes)
ENCODE_ROWS, DELTA_FRAMES, UPDATE_FRAMES = 6, 8, 6
# the traced part at the window's end
TRACE_SECONDS = 10.0


class _Probe:
    """Wraps the tracker's frame program: per call the counters the
    per-layer metrics read, straight from the host's int table, and at the
    armed calls that run an update the state before and after it."""

    def __init__(self, droid, sync):
        self.sync = sync
        self.fp = droid.frame_programs
        self.orig = self.fp.run
        self.fp.run = self._run
        self.calls = []          # per frame program: counters
        self.samples = []        # snapshots of armed frames
        self.armed = False
        self.excluded = 0.0      # seconds of snapshot copies
        self.readback = None     # the previous call's
        self.keep_thresh = 2.0 * droid.frontend.keyframe_thresh

    def close(self):
        self.fp.run = self.orig
        self._resolve()

    def _resolve(self):
        """The previous call's keep flag from its readback, which
        ``track()`` has waited for; the pinned buffer is then free."""
        if self.readback is not None:
            self.calls[-1]["keep"] = \
                float(self.readback.numpy()[0]) >= self.keep_thresh
            self.readback = None

    def _run(self, g, key, ints, floats, image, sens):
        from droid_slam_tpu_torch.slam import fused_frame
        self._resolve()
        ints = np.asarray(ints)
        head = len(fused_frame.HEAD)
        n_iters = int(ints[fused_frame.HEAD.index("n_iters")])
        rec = {"update": n_iters > 0, "edges": len(g.ii),
               "iters1": key.iters1, "iters2": key.iters2}
        if n_iters > 0:
            off = head + 2 * key.ea + 3 * key.kb      # ae_slots
            rec["new"] = int((ints[off:off + key.kb] < g.capacity).sum())
            rec["frames"] = len(np.unique(g.ii))
        snap = None
        if self.armed and n_iters > 0:
            self.armed = False
            self.sync()
            tic = time.perf_counter()
            import torch
            t, tabs = fused_frame.unpack_frame(torch.as_tensor(ints), key)
            snap = self._before(g, key, t, tabs, floats)
            self.sync()
            self.excluded += time.perf_counter() - tic
        out = self.orig(g, key, ints, floats, image, sens)
        self.readback = out
        if snap is not None:
            self.sync()
            tic = time.perf_counter()
            lo, hi = snap["rows"]
            v = g.video
            snap["post_poses"] = v.poses[lo:hi].clone()
            snap["post_disps"] = v.disps[lo:hi].clone()
            snap["kf_dist"] = float(out.numpy()[0])
            self.sync()
            self.excluded += time.perf_counter() - tic
            self.samples.append(snap)
        self.calls.append(rec)
        return out

    def _before(self, g, key, t, tabs, floats):
        """The state the frame's update starts from (see
        ``reference.tracking.frame_update``), rows [lo, hi) of the video
        renumbered from 0."""
        import torch
        v = g.video
        dev = v.device
        ii, jj, slots = g.ii.copy(), g.jj.copy(), g.slots.copy()
        cap, icap = g.capacity, g.inactive_capacity
        new_slots = t["ae_slots"].numpy()
        new_slots = new_slots[new_slots < cap]
        new = np.isin(slots, new_slots)
        mv_src, mv_dst = t["mv_src"].numpy(), t["mv_dst"].numpy()
        moved = dict((int(d), int(s)) for s, d in zip(mv_src, mv_dst)
                     if s < cap and d < icap)
        t0 = max(1, int(ii.min()) + 1)
        lo = max(0, min(int(ii.min()), int(jj.min()), t0 - 3))
        t1f = int(tabs.ns_t1)
        hi = min(max(t1f + 1, int(ii.max()) + 1, int(jj.max()) + 1),
                 v.buffer)
        m = (g.ii_inac >= lo) & (g.jj_inac >= lo)
        islots = g.inac_slots[m]
        src = [moved.get(int(d), -1) for d in islots]
        is_mv = torch.as_tensor([s >= 0 for s in src], device=dev,
                                dtype=torch.bool)
        src_t = torch.as_tensor([max(s, 0) for s in src], device=dev,
                                dtype=torch.long)
        isl_t = torch.as_tensor(islots, device=dev, dtype=torch.long)
        sl_t = torch.as_tensor(slots, device=dev, dtype=torch.long)
        pick = lambda act, inac: torch.where(
            is_mv[:, None, None], act[src_t], inac[isl_t])
        tstamp = v.tstamp[lo:hi].cpu().numpy().astype(np.int64)
        wf = int(t["wf_index"])
        if lo <= wf < hi:
            tstamp[wf - lo] = int(floats[0])
        return {
            "rows": (lo, hi), "first": lo, "tstamp": tstamp,
            "poses": v.poses[lo:hi].clone(), "disps": v.disps[lo:hi].clone(),
            "damping": v.damping[lo:hi].clone(),
            "ii": ii - lo, "jj": jj - lo, "new": new,
            "net": g.net_e[sl_t].clone(), "target": g.target_e[sl_t].clone(),
            "weight": g.weight_e[sl_t].clone(),
            "ii_in": g.ii_inac[m] - lo, "jj_in": g.jj_inac[m] - lo,
            "target_in": pick(g.target_e, g.target_inac_p).clone(),
            "weight_in": pick(g.weight_e, g.weight_inac_p).clone(),
            "t1": t1f - lo, "wf_index": wf,
        }


def tracker_config(config, device):
    from droid_slam_tpu_torch.config import DroidConfig
    keys = {f.name for f in dataclasses.fields(DroidConfig)}
    kw = {k: v for k, v in config.items() if k in keys}
    kw["image_size"] = tuple(config["image_size"])
    kw["weights"] = harness.weights_path(config)
    return DroidConfig(**kw)


def run(cell, seed, seconds, trace, device, t_start, control=False):
    import torch
    from droid_slam_tpu_torch.slam.droid import Droid

    cfg, tr = cell.config, cell.traffic
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else \
        (lambda: None)
    H, W = cfg["image_size"]
    n_frames = min(WARMUP_LIMIT + int(np.ceil(seconds * STREAM_FPS)),
                   cfg["buffer"])
    rng = np.random.default_rng([seed, 1])
    stages = {"start_s": time.perf_counter() - t_start}
    images, intr = box_walk.stream(n_frames, (H, W), tr["walk_seed"],
                                   seed, tr["step"], tr["rot_step"], device)
    stages["stream_s"] = time.perf_counter() - t_start
    droid = Droid(tracker_config(cfg, device), device=device)
    stages["tracker_s"] = time.perf_counter() - t_start
    fp = droid.frame_programs
    if fp is None:
        raise RuntimeError("the tracker is not on the frame path")
    # warm-up: the initialization, then WARMUP_FRAMES frames on the frame
    # path (its first captures)
    k = 0
    while fp.replays + fp.eager < WARMUP_FRAMES:
        if k >= min(WARMUP_LIMIT, n_frames // 2):
            raise RuntimeError(f"{k} frames did not warm the tracker up")
        droid.track(float(k), images[k], intrinsics=intr)
        k += 1
    warm = k
    sync()
    v = droid.video
    anchor0 = int(v.tstamp[v.counter - 1])
    n_log0 = len(droid._delta_log)
    captures0 = droid.frame_programs.captures
    probe = _Probe(droid, sync)
    # the armed frames: a sample of update frames over the window
    arm_at = sorted(rng.uniform(0.1, 0.7, UPDATE_FRAMES) * seconds)
    setup_s = time.perf_counter() - t_start

    call_s = []
    rec = timeline.Recorder(trace, harness.trace_dir)
    trace_from = None    # the first frame of the traced part
    t0 = time.perf_counter()
    while True:
        el = time.perf_counter() - t0 - probe.excluded
        if el >= seconds:
            break
        if trace and trace_from is None and el >= seconds - TRACE_SECONDS:
            # the profiler's own start-up stays out of the window
            trace_from = k - warm
            probe.excluded += rec.start()
        if arm_at and el >= arm_at[0]:
            arm_at.pop(0)
            probe.armed = True
        if k >= n_frames:
            raise RuntimeError(
                f"the stream of {n_frames} frames ran out after "
                f"{el:.1f} s: the tracker is faster than {STREAM_FPS} "
                "frames/s, or the configuration's buffer is too short")
        ex = probe.excluded
        with timeline.span("track"):
            tic = time.perf_counter()
            droid.track(float(k), images[k], intrinsics=intr)
            toc = time.perf_counter()
        call_s.append(toc - tic - (probe.excluded - ex))
        k += 1
    sync()
    window_s = time.perf_counter() - t0 - probe.excluded
    rec.stop()
    probe.close()
    device_rec = harness.device_record(device, 1)

    frames = k - warm
    deltas = np.asarray(droid._delta_log[n_log0:], np.float64)
    if len(deltas) != frames:
        raise RuntimeError(f"{len(deltas)} admission deltas read back for "
                           f"{frames} frames")
    thresh = droid.filterx.thresh
    calls = probe.calls[-frames:] if frames else []
    captures = droid.frame_programs.captures - captures0

    # the keyframe rows written in the window, a sample of them copied
    cnt = v.counter
    ts = v.tstamp[:cnt].cpu().numpy().astype(np.int64)
    rows = np.flatnonzero(ts >= warm - 1)
    rows = rng.choice(rows, min(ENCODE_ROWS, len(rows)),
                      replace=False) if len(rows) else rows
    written = [{"tstamp": int(ts[r]), "fmap": v.fmaps[r, 0].clone(),
                "net": v.nets[r].clone(), "inp": v.inps[r].clone()}
               for r in rows]
    samples = probe.samples
    del probe, droid, v
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # admission: frame warm-1+i's delta is deltas[i]; each frame's anchor
    # is the newest admitted frame before it
    admitted = deltas > thresh
    anchors, a = [], anchor0
    for i in range(frames):
        anchors.append(a)
        if admitted[i]:
            a = warm - 1 + i
    pick = rng.choice(np.arange(1, frames), min(DELTA_FRAMES,
                                                max(frames - 1, 0)),
                      replace=False) if frames > 1 else []
    delta_set = [(warm - 1 + int(i), anchors[int(i)], float(deltas[i]))
                 for i in pick]

    tic = time.perf_counter()
    data = {"written": written, "deltas": delta_set, "samples": samples}
    readings, ctl = checks.tracking(cell, data, images, intr, device,
                                    control=control)
    check_s = time.perf_counter() - tic

    call_ms = np.asarray(call_s) * 1e3
    upd = [c for c in calls if c["update"]]
    metrics = {
        "track_fps": frames / window_s,
        "track_call_ms_p95": float(np.percentile(call_ms, 95)),
        "setup_s": setup_s,
    }
    if trace:
        tl = rec.timeline()
        # the device's metrics over the traced part, the counters over the
        # whole window
        traced = calls[trace_from:]
        ctx = {"cell": cell, "device": device_rec, "timeline": tl,
               "frames": len(traced), "window_s": tl.window_s,
               "updates": [c for c in traced if c["update"]],
               "image_size": (H, W),
               "window": {"frames": frames, "updates": upd,
                          "admitted": int(admitted.sum()),
                          "captures": captures}}
    info = {"check_s": check_s, "frames": frames,
            "admitted": int(admitted.sum()),
            "updates": len(upd), "captures_in_window": captures,
            "keyframes_removed": int(admitted.sum())
            - int((ts >= warm - 1).sum()),
            "track_call_ms_p50": float(np.median(call_ms)),
            "setup_stages_s": stages, "warm_frames": warm,
            "card": harness.power_limit() if cuda else None}
    out = {"metrics": metrics, "readings": readings, "control": ctl,
           "attempted": frames, "failed": 0, "device": device_rec,
           "info": info}
    if trace:
        device_rec.update(busy_s=tl.busy_s, window_s=tl.window_s)
        out["metrics"] = harness.read_metrics(cell, ctx)
        out["breakdown"] = tl.breakdown()
    return out
