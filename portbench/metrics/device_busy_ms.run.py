"""Device: milliseconds a run in which a kernel, copy or set ran on the card
(the union of the device events' intervals), from the profiler's trace."""


def read(run):
    runs = run.counts.get("runs")
    if not run.device or not runs:
        return None
    return run.device["busy_s"] * 1e3 / runs
