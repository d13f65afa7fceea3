"""Device: megabytes a run copied from the card to the host, the program's
``device.d2h_bytes`` counts over the window (every transfer point of the
port counts the tensors it copies back)."""

from portbench.program_log import total, window


def read(run):
    log = window(run)
    if log is None:
        return None
    return total(log[1], "device.d2h_bytes") / 1e6 / run.counts["runs"]
