"""The port's own spans (``droid:``, ``droid_slam_tpu_torch/utils/trace.py``)
in a trace the benchmark reads: as host events they leave the device's
timeline, its idle gaps and every per-layer metric where they were. A
synthetic trace of each cell, read with and without them."""

import pytest

from benchmark import harness, timeline

CARD = "NVIDIA H100 80GB HBM3"
MS = 1_000_000


class _Event:
    def __init__(self, name, start_ms, end_ms, device):
        self._name, self._dev = name, device
        self._a, self._b = int(start_ms * MS), int(end_ms * MS)

    def name(self):
        return self._name

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._dev else DeviceType.CPU


class _Profile:
    """What ``Timeline.from_profiler`` reads of a ``torch.profiler``
    profile."""

    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def _trace(calls, call_ms, program_spans):
    """A window of ``calls`` calls of ``call_ms`` each, under ``bench:``
    spans; per call a convolution, the lookup kernel and an elementwise
    kernel on the device, with idle gaps between; with
    ``program_spans`` the port's host spans inside each call."""
    ev = [_Event("bench:window", 0, calls * call_ms + 2, False)]
    for k in range(calls):
        t = 1 + k * call_ms
        ev.append(_Event("bench:track", t, t + call_ms, False))
        ev += [_Event("sm90_xmma_fprop_implicit_gemm_bf16", t + 3, t + 20,
                      True),
               _Event("corr_lookup_kernel", t + 20, t + 22, True),
               _Event("elementwise_kernel", t + 25, t + call_ms - 5, True)]
        if program_spans:
            ev += [_Event("droid:track", t, t + call_ms, False),
                   _Event("droid:resolve", t, t + 3, False),
                   _Event("droid:readback_wait", t + 0.5, t + 2.5, False),
                   _Event("droid:update_host", t + 3, t + 4, False),
                   _Event("droid:proposal", t + 3.2, t + 3.8, False),
                   _Event("droid:pack", t + 22, t + 24, False),
                   _Event("droid:dispatch", t + 24, t + 25, False),
                   _Event("droid:sweep_chunk", t + 22, t + 25, False),
                   _Event("droid:ba", t + 26, t + 30, False)]
    return _Profile(ev)


def _ctx(cell, tl, frames):
    upd = [{"update": True, "edges": 40, "iters1": 3, "iters2": 2,
            "keep": k % 3 != 0, "new": 2, "frames": 9}
           for k in range(frames // 2)]
    return {"cell": cell, "device": {"kind": CARD}, "timeline": tl,
            "frames": frames, "window_s": tl.window_s, "updates": upd,
            "image_size": (320, 512),
            "window": {"frames": frames, "updates": upd, "admitted": 30,
                       "captures": 1},
            "passes": 2, "steps_per_pass": 2, "steps": 4,
            "edges": [7000, 7100], "keyframes": 512,
            "spans": {"proposal": 0.8, "distance": 0.3, "sweep_ba": 17.0,
                      "ba": 0.5}}


@pytest.mark.parametrize("workload",
                         [w["name"] for w in harness.spec()["workloads"]])
def test_program_spans_move_no_metric(workload):
    cell = harness.Cell(workload)
    frames, read = 40, {}
    for with_spans in (False, True):
        tl = timeline.Timeline.from_profiler(
            _trace(frames, 60.0, with_spans))
        read[with_spans] = (
            tl.ops, tl.spans, tl.window_s, tl.busy_s, tl.idle_gaps(),
            tl.breakdown(), harness.read_metrics(cell, _ctx(cell, tl,
                                                            frames)))
    assert read[True] == read[False]
    metrics = read[True][-1]
    # every accepted metric of the cell found something to read
    assert set(metrics) == {m["name"] for m in cell.per_layer}
    assert 0 < metrics.get("device_idle.track",
                           metrics.get("device_idle.gba")) < 100
