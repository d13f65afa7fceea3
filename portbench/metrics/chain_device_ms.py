"""Kernels: device milliseconds a chain step, every kernel, copy and set of
the window's steps (their union) over the steps, from the profiler's trace."""


def read(run):
    steps = run.counts.get("steps")
    if not run.device or not steps:
        return None
    return run.device["busy_s"] * 1e3 / steps
