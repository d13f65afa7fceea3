"""Storage: bytes the event layer's tables add to the cache, per waveform
served: the program's ``cache.bytes_written.<name>`` counts over the window
for the names below."""

from portbench.program_log import saved_bytes_per_waveform

NAMES = {"hit_merged", "hit_merged_components", "hit_merge_clusters", "df", "df_events",
         "hit_grouped", "df_paired"}


def read(run):
    return saved_bytes_per_waveform(run, NAMES)
