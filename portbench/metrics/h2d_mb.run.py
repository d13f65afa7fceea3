"""Device: megabytes a run copied from the host to the card, the program's
``device.h2d_bytes`` counts over the window (every transfer point of the
port counts the arrays it uploads)."""

from portbench.program_log import total, window


def read(run):
    log = window(run)
    if log is None:
        return None
    return total(log[1], "device.h2d_bytes") / 1e6 / run.counts["runs"]
