"""Kernels: the chain step's share of its roofline, in percent: the least
time of the entry's contract (make_chain_scan's inputs read once and its
outputs written once, over the HBM rate, or its float32 operations over
the f32 peak, whichever is longer; portbench.roofline) over the device time
a step (every kernel, copy and set of the window's steps over the steps)."""

from portbench.roofline import chain_bytes, chain_ops, least_seconds


def read(run):
    steps = run.counts.get("steps")
    if not run.device or not steps:
        return None
    least, _ = least_seconds(chain_bytes(run.counts["events"], run.counts["wave_length"]),
                             chain_ops(run.counts["events"], run.counts["wave_length"]))
    return 100.0 * least / (run.device["busy_s"] / steps)
