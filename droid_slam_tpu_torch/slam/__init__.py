"""The tracking pipeline, and ``make_droid``, which picks its facade."""

import os


def make_droid(cfg, **kw):
    """The facade ``cfg`` asks for (droid_slam_tpu/slam/__init__.py:7-20):
    ``Droid`` (synchronous), or with ``cfg.asynchronous`` ``DroidAsync``
    (backend in a thread), or, when ``DROID_ASYNC_PROCESS=1`` is set,
    ``DroidAsyncProcess`` (backend in a spawned process). ``kw`` goes to
    the facade (``device``; ``sleep_time``, ``backend_iters`` and, for the
    process, ``push_time`` of the asynchronous ones)."""
    if not cfg.asynchronous:
        from .droid import Droid
        return Droid(cfg, **kw)
    if os.environ.get("DROID_ASYNC_PROCESS", "0") == "1":
        from .async_process import DroidAsyncProcess
        return DroidAsyncProcess(cfg, **kw)
    from .async_droid import DroidAsync
    return DroidAsync(cfg, **kw)
