"""Storage: bytes the filter and the members add to the cache, per
waveform served (their capacity hints included): the program's
``cache.bytes_written.<name>`` counts over the window for the names below
(filtered_waveforms is saved only where it is a target)."""

from portbench.program_log import saved_bytes_per_waveform

NAMES = {"filtered_waveforms", "basic_features", "hit_threshold", "hit", "waveform_width",
         "s1_s2"}


def read(run):
    return saved_bytes_per_waveform(run, NAMES)
