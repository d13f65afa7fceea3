"""Wall-clock spans and counts: per-key aggregates and a bounded log.

Behavioral analog of the reference Profiler
(reference: waveform_analysis/core/foundation/utils.py:92): context-manager
timers aggregated per key, with a text summary. Extended here into a span
recorder. Each ``Profiler.time(key)`` also appends one record to a
process-wide log: its key, start and end on ``time.time_ns()`` (the clock of
``torch.profiler``'s device events), thread, parent span (a thread-local
stack) and request. ``Profiler.count(key, n)`` adds to a per-key counter and
logs a sample. The log keeps the newest ``LOG_CAPACITY`` records and counts
what it dropped; read it with ``spans()`` and ``counts()`` over a window,
or write it as a Chrome trace with ``export_chrome_trace``.

Code with no Profiler at hand records through the module-level ``span`` and
``count``, which reach the innermost profiler with a span open on this
thread. ``handoff()`` and ``adopt()`` carry a thread's request and span to
work it hands to another thread.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from _thread import get_ident
from collections import deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

# a records request of 16 channels at ragged lengths logs about 20,000
# records (three phases a filter batch): the log holds six
LOG_CAPACITY = 1 << 17


class Span(NamedTuple):
    key: str
    start_ns: int
    end_ns: int
    thread: int  # threading.get_ident()
    span_id: int
    parent_id: int  # 0: no parent
    request_id: int  # 0: outside any request


class Count(NamedTuple):
    key: str
    t_ns: int
    n: int
    thread: int
    span_id: int  # the innermost open span on the thread, 0 for none
    request_id: int


class _Log:
    """The newest ``capacity`` records, as plain tuples led by ``Span`` or
    ``Count`` (the cheapest to make); what falls out is counted."""

    def __init__(self, capacity: int) -> None:
        self._records: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.dropped = 0
        self._dropped_until = -1  # the latest time among the dropped records

    def append(self, rec: tuple) -> None:
        records = self._records
        with self._lock:
            if len(records) == records.maxlen:
                self.dropped += 1
                old = records[0]
                t = old[3] if old[0] is Span else old[2]  # a span's end, a count's time
                if t > self._dropped_until:
                    self._dropped_until = t
            records.append(rec)

    def read(self, kind: type, start_ns: int, end_ns: Optional[int]) -> List[Any]:
        with self._lock:
            if self._dropped_until >= start_ns:
                raise RuntimeError(
                    f"the profiler's log dropped records inside the window from {start_ns} ns "
                    f"(it holds {self._records.maxlen}; {self.dropped} dropped)")
            recs = [r for r in self._records if r[0] is kind]
        hi = end_ns if end_ns is not None else float("inf")
        if kind is Span:
            return [Span._make(r[1:]) for r in recs if r[3] >= start_ns and r[2] <= hi]
        return [Count._make(r[1:]) for r in recs if start_ns <= r[2] <= hi]


_LOG = _Log(LOG_CAPACITY)
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)


class _ThreadState(threading.local):
    def __init__(self) -> None:
        # open spans, innermost last: [profiler, span id, ns its children took]
        self.stack: List[list] = []
        self.request = 0


_THREAD = _ThreadState()


@dataclass
class _TimerStats:
    count: int = 0
    total_s: float = 0.0
    self_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0
    last_s: float = 0.0

    def add(self, dt: float, self_dt: Optional[float] = None) -> None:
        self.count += 1
        self.total_s += dt
        self.self_s += dt if self_dt is None else self_dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)
        self.last_s = dt

    def to_dict(self) -> Dict[str, Any]:
        avg = self.total_s / self.count if self.count else 0.0
        return {
            "count": self.count,
            "total_s": self.total_s,
            "self_s": self.self_s,
            "avg_s": avg,
            "min_s": self.min_s if self.count else 0.0,
            "max_s": self.max_s,
            "last_s": self.last_s,
        }


class Profiler:
    """Aggregating timer and span recorder. Thread-safe; keys are free-form
    strings.

    Usage::

        prof = Profiler()
        with prof.time("plugin.basic_features.compute"):
            ...
        print(prof.summary())

    A key's self time is its spans' durations less the time of the spans
    opened inside them on the same thread. Program code never uses the value
    ``time()`` yields (a subclass may yield its own).
    """

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._stats: Dict[str, _TimerStats] = {}
        self._counters: Dict[str, int] = {}
        self._lock = threading.Lock()

    @contextmanager
    def time(self, key: str, result: Any = None) -> Iterator[None]:
        """Time the block as one span of ``key``. ``result`` is accepted for
        callers that name what the block produces; it changes nothing."""
        if not self.enabled:
            yield
            return
        state = _THREAD
        stack = state.stack
        parent = stack[-1] if stack else None
        entry = [self, next(_span_ids), 0]
        stack.append(entry)
        t0 = time.time_ns()
        try:
            yield
        finally:
            t1 = time.time_ns()
            if stack and stack[-1] is entry:
                stack.pop()
            else:  # a generator left its span open across a yield
                stack.remove(entry)
            dt = t1 - t0
            if parent is not None:
                parent[2] += dt
            _LOG.append((Span, key, t0, t1, get_ident(), entry[1],
                         parent[1] if parent is not None else 0, state.request))
            with self._lock:
                st = self._stats.get(key)
                if st is None:
                    st = self._stats[key] = _TimerStats()
                st.add(dt / 1e9, (dt - entry[2]) / 1e9)

    @contextmanager
    def request(self, key: str) -> Iterator[None]:
        """The block as a new request on this thread: a fresh request id for
        every span and count inside it, and its own span ``key``."""
        state = _THREAD
        outer = state.request
        state.request = next(_request_ids)
        try:
            with self.time(key):
                yield
        finally:
            state.request = outer

    def count(self, key: str, n: int) -> None:
        """Add ``n`` to the counter ``key`` and log the sample."""
        if not self.enabled:
            return
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n
        _note(key, n)

    def record(self, key: str, seconds: float) -> None:
        """Record an externally measured duration."""
        with self._lock:
            self._stats.setdefault(key, _TimerStats()).add(seconds)

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            st = self._stats.get(key)
            return st.to_dict() if st else None

    def stats(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {k: v.to_dict() for k, v in self._stats.items()}

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def reset(self) -> None:
        """Clear the aggregates and counters (the process's log stays)."""
        with self._lock:
            self._stats.clear()
            self._counters.clear()

    def summary(self, sort_by: str = "total_s") -> str:
        rows = sorted(self.stats().items(), key=lambda kv: -kv[1].get(sort_by, 0.0))
        if not rows:
            return "(no profiling data)"
        width = max(len(k) for k, _ in rows)
        lines = [f"{'key'.ljust(width)}  count    total(s)     self(s)      avg(s)      max(s)"]
        for k, st in rows:
            lines.append(
                f"{k.ljust(width)}  {st['count']:5d}  {st['total_s']:10.4f}  {st['self_s']:10.4f}"
                f"  {st['avg_s']:10.6f}  {st['max_s']:10.6f}"
            )
        counters = self.counters()
        if counters:
            width = max(len(k) for k in counters)
            lines += ["", f"{'counter'.ljust(width)}  total"]
            lines += [f"{k.ljust(width)}  {v}" for k, v in sorted(counters.items())]
        return "\n".join(lines)

    # the process's log, which every Profiler writes

    @staticmethod
    def spans(start_ns: int = 0, end_ns: Optional[int] = None) -> List[Span]:
        return spans(start_ns, end_ns)

    @staticmethod
    def counts(start_ns: int = 0, end_ns: Optional[int] = None) -> List[Count]:
        return counts(start_ns, end_ns)

    @staticmethod
    def export_chrome_trace(path: str, start_ns: int = 0, end_ns: Optional[int] = None) -> None:
        export_chrome_trace(path, start_ns, end_ns)


def _note(key: str, n: int) -> None:
    state = _THREAD
    stack = state.stack
    _LOG.append((Count, key, time.time_ns(), int(n), get_ident(),
                 stack[-1][1] if stack else 0, state.request))


def active() -> Optional[Profiler]:
    """The innermost profiler with a span open on this thread, or None."""
    stack = _THREAD.stack
    return stack[-1][0] if stack else None


def span(key: str):
    """A span of ``key`` through ``active()``'s own ``time()``; nothing
    without an active profiler."""
    prof = active()
    return prof.time(key) if prof is not None else nullcontext()


def count(key: str, n: int) -> None:
    """``n`` more of ``key``: through ``active()``'s ``count()``, else into
    the log alone."""
    prof = active()
    if prof is not None:
        prof.count(key, n)
    else:
        _note(key, n)


def current_request() -> int:
    """This thread's request id; 0 outside any request."""
    return _THREAD.request


def handoff() -> Tuple[Optional[Profiler], int, int]:
    """What work handed to another thread needs to continue this thread's
    request there: (active profiler, innermost span id, request id)."""
    stack = _THREAD.stack
    top = stack[-1] if stack else None
    return (top[0] if top else None, top[1] if top else 0, _THREAD.request)


@contextmanager
def adopt(token: Tuple[Optional[Profiler], int, int]) -> Iterator[None]:
    """Continue ``handoff()``'s request on this thread: spans opened in the
    block take its span as their parent and its request id."""
    prof, span_id, request_id = token
    state = _THREAD
    outer = state.request
    state.request = request_id
    entry = [prof, span_id, 0] if prof is not None else None
    if entry is not None:
        state.stack.append(entry)
    try:
        yield
    finally:
        if entry is not None:
            state.stack.remove(entry)
        state.request = outer


def spans(start_ns: int = 0, end_ns: Optional[int] = None) -> List[Span]:
    """The logged spans that overlap [start_ns, end_ns], in the order they
    ended. Raises if the log dropped a record of the window."""
    return _LOG.read(Span, start_ns, end_ns)


def counts(start_ns: int = 0, end_ns: Optional[int] = None) -> List[Count]:
    """The logged count samples taken in [start_ns, end_ns]. Raises if the
    log dropped a record of the window."""
    return _LOG.read(Count, start_ns, end_ns)


def dropped() -> int:
    """Records the log has dropped since the process started."""
    return _LOG.dropped


def export_chrome_trace(path: str, start_ns: int = 0, end_ns: Optional[int] = None) -> None:
    """Write the log's spans (``X`` events) and counts (``C`` events, each
    key's running total) as Chrome trace-event JSON, in microseconds on the
    ``time.time_ns()`` clock, for chrome://tracing or Perfetto beside a
    ``torch.profiler`` trace of the same process."""
    pid = os.getpid()
    events: List[Dict[str, Any]] = [
        {"name": s.key, "ph": "X", "ts": s.start_ns / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
         "pid": pid, "tid": s.thread,
         "args": {"span_id": s.span_id, "parent_id": s.parent_id, "request_id": s.request_id}}
        for s in spans(start_ns, end_ns)]
    totals: Dict[str, int] = {}
    for c in sorted(counts(start_ns, end_ns), key=lambda c: c.t_ns):
        totals[c.key] = totals.get(c.key, 0) + c.n
        events.append({"name": c.key, "ph": "C", "ts": c.t_ns / 1e3, "pid": pid,
                       "args": {"total": totals[c.key]}})
    with open(path, "w") as fh:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, fh)
