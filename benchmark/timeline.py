"""The device's timeline from a ``torch.profiler`` trace of the measured
window: when the device was busy, which operations took its time, and what
the host was doing (the benchmark's own ``bench:`` spans) while it idled.

The window is the ``bench:window`` span. A device operation is any event
the trace places on the CUDA device (kernels, copies, memsets; CUPTI
records the kernels inside CUDA graph replays one by one) other than the
device-side copies of the ``bench:`` spans; busy time is the union of
their intervals inside the window."""

from __future__ import annotations

import bisect
import json
import time
from collections import defaultdict

WINDOW = "bench:window"


class Timeline:
    """Device operations and host spans of one trace, in seconds from the
    window's start."""

    def __init__(self, ops, spans, window):
        self.ops = ops            # [(name, start_s, end_s)], by start
        self.spans = spans        # [(name, start_s, end_s)]
        self.window_s = window

    @classmethod
    def from_profiler(cls, prof):
        from torch.autograd import DeviceType
        ops, spans, win = [], [], None
        for e in prof.profiler.kineto_results.events():
            start, dur = e.start_ns(), e.duration_ns()
            on_device = e.device_type() == DeviceType.CUDA
            if e.name().startswith("bench:"):
                # the device-side copy of an annotation is no operation
                if not on_device:
                    spans.append((e.name(), start, start + dur))
                    if e.name() == WINDOW:
                        win = (start, start + dur)
            elif on_device:
                ops.append((e.name(), start, start + dur))
        if win is None:
            raise RuntimeError("the trace holds no bench:window span")
        t0, t1 = win
        clip = lambda a, b: (max(a, t0), min(b, t1))
        ops = [(n,) + tuple((x - t0) * 1e-9 for x in clip(a, b))
               for n, a, b in ops if b > t0 and a < t1]
        ops.sort(key=lambda o: o[1])
        spans = [(n, (a - t0) * 1e-9, (b - t0) * 1e-9) for n, a, b in spans
                 if n != WINDOW]
        return cls(ops, spans, (t1 - t0) * 1e-9)

    def busy_intervals(self):
        out = []
        for _, a, b in self.ops:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals())

    def time_by_name(self):
        t = defaultdict(float)
        for n, a, b in self.ops:
            t[n] += b - a
        return dict(t)

    def idle_gaps(self):
        """The idle intervals of the window, each labelled with the
        innermost benchmark span open at its midpoint."""
        gaps, prev = [], 0.0
        for a, b in self.busy_intervals() + [[self.window_s] * 2]:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        spans = sorted(self.spans, key=lambda s: s[1])
        starts = [s[1] for s in spans]
        out = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            k = bisect.bisect_right(starts, mid)
            # spans nest shallowly: the innermost open one starts last
            open_ = [s for s in spans[max(k - 64, 0):k] if mid < s[2]]
            label = (min(open_, key=lambda s: s[2] - s[1])[0] if open_
                     else "bench:between_spans")
            out.append((label, b - a))
        return out

    def breakdown(self, top=10):
        ops = sorted(self.time_by_name().items(), key=lambda kv: -kv[1])
        idle = defaultdict(float)
        for label, s in self.idle_gaps():
            idle[label] += s
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n, s] for n, s in ops[:top]],
                "idle_gaps": [[n, s] for n, s in gaps[:top]]}


def span(name):
    """A ``bench:`` span in the trace (a no-op outside a profile)."""
    import torch
    return torch.profiler.record_function("bench:" + name)


class Recorder:
    """``torch.profiler`` over a part of the window when ``enabled``:
    ``start()`` starts the profiler and opens the ``bench:window`` span,
    ``stop()`` closes both; each returns its own seconds, which the run
    leaves out of the window. ``timeline()`` reads the trace afterwards and
    writes a summary under ``trace_dir()``."""

    def __init__(self, enabled, trace_dir):
        self.enabled, self.trace_dir = enabled, trace_dir
        self.running = False
        self._prof = self._span = None

    def start(self):
        if not self.enabled:
            return 0.0
        import torch
        from torch.profiler import ProfilerActivity, profile
        tic = time.perf_counter()
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._span = span("window")
        self._span.__enter__()
        self.running = True
        return time.perf_counter() - tic

    def stop(self):
        if not self.running:
            return 0.0
        tic = time.perf_counter()
        self._span.__exit__(None, None, None)
        self._prof.stop()
        self.running = False
        return time.perf_counter() - tic

    def timeline(self):
        if self._prof is None:
            return None
        import os
        tl = Timeline.from_profiler(self._prof)
        with open(os.path.join(self.trace_dir(), "timeline_summary.json"),
                  "w") as f:
            json.dump({"window_s": tl.window_s, "busy_s": tl.busy_s,
                       "time_by_name": tl.time_by_name(),
                       "breakdown": tl.breakdown(40)}, f)
        return tl
