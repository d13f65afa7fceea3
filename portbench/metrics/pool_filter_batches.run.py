"""Records: filter batches a run of ``wave_pool_filtered`` on the device,
one a (board, channel) and record length, each gathered, filtered and
scattered with a sync after each step: the program's
``wave_pool_filtered.batches`` counts over the window. A program without
the count gives no value."""

from portbench.program_log import total, window


def read(run):
    log = window(run)
    if log is None:
        return None
    batches = total(log[1], "wave_pool_filtered.batches")
    return batches / run.counts["runs"] if batches else None
