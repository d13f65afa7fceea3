"""Storage: bytes the ingest layer's tables add to the cache, per waveform
served: the program's ``cache.bytes_written.<name>`` counts over the window
(payload, metadata and lineage of every save) for the names below."""

from portbench.program_log import saved_bytes_per_waveform

NAMES = {"st_waveforms"}


def read(run):
    return saved_bytes_per_waveform(run, NAMES)
