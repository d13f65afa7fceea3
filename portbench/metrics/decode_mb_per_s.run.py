"""Ingest: the decoder's rate in megabytes a second: the bytes of the run
files handed to it (``st_waveforms.decode_bytes``) over the union of the
``st_waveforms.decode`` spans of the window, from the program's log."""

from portbench.program_log import seconds, total, window


def read(run):
    log = window(run)
    if log is None:
        return None
    spans, counts = log
    s = seconds([(x.start_ns, x.end_ns) for x in spans if x.key == "st_waveforms.decode"])
    return total(counts, "st_waveforms.decode_bytes") / 1e6 / s if s else None
