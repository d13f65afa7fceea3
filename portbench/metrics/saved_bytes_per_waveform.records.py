"""Storage: bytes the records layer's tables add to the cache, per waveform
served: the program's ``cache.bytes_written.<name>`` counts over the window
(payload, metadata and lineage of every save) for the names below, summed
here (the shared reader refuses tables that its layers do not name)."""

from portbench.program_log import SAVED, window

NAMES = {"records", "wave_pool", "wave_pool_filtered"}


def read(run):
    log = window(run)
    if log is None:
        return None
    saved = sum(c.n for c in log[1] if c.key.startswith(SAVED) and c.key[len(SAVED):] in NAMES)
    return saved / run.counts["waveforms"] if saved else None
