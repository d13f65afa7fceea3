"""Device: the share of the chain window in which no kernel, copy or set ran
on the card, in percent (1 - the union of the device events' intervals /
the window), from the profiler's trace."""

from portbench.trace import idle_share


def read(run):
    if not run.device:
        return None
    return 100.0 * idle_share(run.device["busy_s"], run.window_s)
