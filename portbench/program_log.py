"""The program's own span and count log over a run's window.

The port's Profiler (``waveformanalysis_tpu_torch.foundation.profiler``)
logs every span and count of the process; the readers of the per-layer
metrics that rest on it take the records of the measured window from here.
A program without that log (an older one) gives ``None``, and the metric
stays out of the line. The log raises rather than hand back a window it
dropped records of.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from portbench.harness import load_named
from portbench.trace import Interval, union


def window(run) -> Optional[Tuple[list, list]]:
    """(spans, counts) of the program's log over ``run``'s window, or None
    where the program keeps no such log or the window finished no run."""
    try:
        from waveformanalysis_tpu_torch.foundation import profiler
    except ImportError:
        return None
    if not hasattr(profiler, "spans") or not run.counts.get("runs"):
        return None
    return profiler.spans(run.rec.t0, run.rec.t1), profiler.counts(run.rec.t0, run.rec.t1)


def total(counts: Iterable, key: str) -> int:
    return sum(c.n for c in counts if c.key == key)


def seconds(intervals: List[Interval]) -> float:
    return sum(e - s for s, e in union(intervals)) / 1e9


def uncovered_s(outer: List[Interval], inner: List[Interval]) -> float:
    """Seconds of the union of ``outer`` that the union of ``inner`` does not cover."""
    out = union(outer)
    covered = 0
    for s, e in union(inner):
        for os_, oe in out:
            lo, hi = max(s, os_), min(e, oe)
            if hi > lo:
                covered += hi - lo
    return sum(e - s for s, e in out) / 1e9 - covered / 1e9


SAVED = "cache.bytes_written."
SAVED_LAYERS = ("ingest", "members", "events")


def saved_bytes_per_waveform(run, names) -> Optional[float]:
    """Bytes the saves of ``names`` added to the cache over the window, per
    waveform served. A table saved in the window that no layer's reader
    names fails the read: no byte of the cache goes uncounted."""
    log = window(run)
    if log is None:
        return None
    known = set().union(*(load_named("metrics", f"saved_bytes_per_waveform.{layer}").NAMES
                          for layer in SAVED_LAYERS))
    saved = {c.key[len(SAVED):] for c in log[1] if c.key.startswith(SAVED)}
    if saved - known:
        raise KeyError(f"tables saved in the window that no saved_bytes_per_waveform "
                       f"reader names: {sorted(saved - known)}")
    return sum(c.n for c in log[1] if c.key.startswith(SAVED)
               and c.key[len(SAVED):] in names) / run.counts["waveforms"]
