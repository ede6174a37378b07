"""Closed-loop stereo tracking: ``loops/track.py``'s loop, window, probe and
trace over rectified pairs of the box walk (``traffic/box_walk_stereo.py``),
each ``Droid.track()`` call given a [2,H,W,3] stack, left view first.

What differs from the monocular loop: the stream, the keyframe rows copied
for the check (both views' features), the check itself
(``checks_stereo.py``: the stereo reference), and the metrics' context,
which also holds the change over the window of the tracker's stereo edge
counters (``update_stereo_edges``, ``new_stereo_edges``), None where the
tracker has no such counters."""

from __future__ import annotations

import gc
import time

import numpy as np

from benchmark import checks_stereo, harness, timeline
from benchmark.loops.track import (DELTA_FRAMES, ENCODE_ROWS, STREAM_FPS,
                                   TRACE_SECONDS, UPDATE_FRAMES,
                                   WARMUP_LIMIT, _Probe, tracker_config)
from benchmark.loops import track
from benchmark.traffic import box_walk_stereo

COUNTERS = ("update_stereo_edges", "new_stereo_edges")


def _counters(droid):
    return {n: getattr(droid, n, None) for n in COUNTERS}


def run(cell, seed, seconds, trace, device, t_start, control=False):
    import torch
    from droid_slam_tpu_torch.slam.droid import Droid

    cfg, tr = cell.config, cell.traffic
    if not cfg.get("stereo"):
        raise ValueError(f"{cell.name}: the stereo loop needs a stereo "
                         "configuration")
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else \
        (lambda: None)
    H, W = cfg["image_size"]
    n_frames = min(WARMUP_LIMIT + int(np.ceil(seconds * STREAM_FPS)),
                   cfg["buffer"])
    rng = np.random.default_rng([seed, 1])
    stages = {"start_s": time.perf_counter() - t_start}
    images, intr = box_walk_stereo.stream(
        n_frames, (H, W), tr["walk_seed"], seed, tr["step"],
        tr["rot_step"], tr["baseline"], device)
    stages["stream_s"] = time.perf_counter() - t_start
    droid = Droid(tracker_config(cfg, device), device=device)
    stages["tracker_s"] = time.perf_counter() - t_start
    fp = droid.frame_programs
    if fp is None:
        raise RuntimeError("the tracker is not on the frame path")
    # warm-up: the initialization, then WARMUP_FRAMES frames on the frame
    # path (its first captures); read from the monocular loop's module, so
    # that a small run may lower it there
    k = 0
    while fp.replays + fp.eager < track.WARMUP_FRAMES:
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
    stereo0 = _counters(droid)
    probe = _Probe(droid, sync)
    arm_at = sorted(rng.uniform(0.1, 0.7, UPDATE_FRAMES) * seconds)
    setup_s = time.perf_counter() - t_start

    call_s = []
    rec = timeline.Recorder(trace, harness.trace_dir)
    trace_from = None
    t0 = time.perf_counter()
    while True:
        el = time.perf_counter() - t0 - probe.excluded
        if el >= seconds:
            break
        if trace and trace_from is None and el >= seconds - TRACE_SECONDS:
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
    stereo = {n: (None if c is None else c - stereo0[n])
              for n, c in _counters(droid).items()}

    frames = k - warm
    deltas = np.asarray(droid._delta_log[n_log0:], np.float64)
    if len(deltas) != frames:
        raise RuntimeError(f"{len(deltas)} admission deltas read back for "
                           f"{frames} frames")
    thresh = droid.filterx.thresh
    calls = probe.calls[-frames:] if frames else []
    captures = droid.frame_programs.captures - captures0

    # the keyframe rows written in the window, a sample of them copied with
    # both views' features
    cnt = v.counter
    ts = v.tstamp[:cnt].cpu().numpy().astype(np.int64)
    rows = np.flatnonzero(ts >= warm - 1)
    rows = rng.choice(rows, min(ENCODE_ROWS, len(rows)),
                      replace=False) if len(rows) else rows
    written = [{"tstamp": int(ts[r]), "fmap": v.fmaps[r].clone(),
                "net": v.nets[r].clone(), "inp": v.inps[r].clone()}
               for r in rows]
    samples = probe.samples
    del probe, droid, v
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

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
    readings, ctl = checks_stereo.tracking(cell, data, images, intr, device,
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
        traced = calls[trace_from:]
        ctx = {"cell": cell, "device": device_rec, "timeline": tl,
               "frames": len(traced), "window_s": tl.window_s,
               "updates": [c for c in traced if c["update"]],
               "image_size": (H, W),
               "window": {"frames": frames, "updates": upd,
                          "admitted": int(admitted.sum()),
                          "captures": captures, **stereo}}
    info = {"check_s": check_s, "frames": frames,
            "admitted": int(admitted.sum()),
            "updates": len(upd), "captures_in_window": captures,
            "keyframes_removed": int(admitted.sum())
            - int((ts >= warm - 1).sum()),
            "sampled_stereo_edges": [int((s["ii"] == s["jj"]).sum())
                                     for s in samples],
            "track_call_ms_p50": float(np.median(call_ms)),
            "setup_stages_s": stages, "warm_frames": warm,
            "card": harness.power_limit() if cuda else None, **stereo}
    out = {"metrics": metrics, "readings": readings, "control": ctl,
           "attempted": frames, "failed": 0, "device": device_rec,
           "info": info}
    if trace:
        device_rec.update(busy_s=tl.busy_s, window_s=tl.window_s)
        out["metrics"] = harness.read_metrics(cell, ctx)
        out["breakdown"] = tl.breakdown()
    return out
