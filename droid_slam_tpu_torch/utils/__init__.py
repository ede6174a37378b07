"""Timers, the profiler's trace, and the command lines' device check."""
