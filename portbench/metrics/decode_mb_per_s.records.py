"""Ingest: the records decoder's rate in megabytes a second: the bytes of
the run files handed to it (``records.decode_bytes``) over the union of the
``records.decode`` spans of the window, from the program's log."""

from portbench.program_log import seconds, total, window


def read(run):
    log = window(run)
    if log is None:
        return None
    spans, counts = log
    s = seconds([(x.start_ns, x.end_ns) for x in spans if x.key == "records.decode"])
    return total(counts, "records.decode_bytes") / 1e6 / s if s else None
