"""Records: megabytes a run of padded wave matrices built from the records
pool, the program's ``records.pad_bytes`` counts over the window. A program
without the count gives no value."""

from portbench.program_log import total, window


def read(run):
    log = window(run)
    if log is None:
        return None
    mb = total(log[1], "records.pad_bytes") / 1e6
    return mb / run.counts["runs"] if mb else None
