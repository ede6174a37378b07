"""Spans of the port's host stages, on the clock of the device trace.

``span(name, args)`` opens ``droid:<name>`` as an event of the running
``torch.profiler`` trace, the same kineto trace that holds the CUDA
kernels: host events read ``time.time_ns()`` and CUPTI's device events
are mapped onto that clock, so a device idle gap can be put down to the
innermost span open over it. Parent and child come from nesting on the
thread. ``args`` (a dict of Python ints, floats and strings) lands in the
event's ``kwinputs`` when the profiler records shapes.

Tracing is on exactly while a profiler records (``torch.profiler.profile``
sets ``torch.autograd.profiler._is_profiler_enabled`` in ``start()`` and
clears it in ``stop()``). Off, ``span`` returns one shared no-op: no
allocation, no string, a flag check. A span never synchronises the device
nor reads a tensor; put none inside code captured into a CUDA graph.

The event is a function-scope record (``_RecordFunctionFast``), not a
``record_function`` user annotation: a user annotation also gets a copy
on the device's timeline, which a reader of device operations would take
for work on the device.

Counters are plain ints on ``slam/droid.py::TrackPipeline``, counted from
values the host already holds, traced or not: ``admitted``, ``updates``,
``update_edges``, ``update_stereo_edges`` (the live (i, i) edges of each
update, summed; 0 without stereo), ``new_stereo_edges`` (the (i, i) edges
the updates added, each with a volume against the right view),
``iters_run`` and ``iters_kept``.
"""

from __future__ import annotations

import torch
from torch.autograd import profiler as _profiler

PREFIX = "droid:"


class _Off:
    """The shared no-op span."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP = _Off()


def span(name, args=None):
    """``with span("pack"): ...``: the block as ``droid:pack`` in the
    running profiler's trace, else nothing."""
    if not _profiler._is_profiler_enabled:
        return NOOP
    if args is None:
        return torch._C._profiler._RecordFunctionFast(PREFIX + name)
    return torch._C._profiler._RecordFunctionFast(PREFIX + name, (), args)
