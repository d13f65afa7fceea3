"""Spans, counters and the device trace of a run's measured window.

The ``Recorder`` keeps host spans (key, start, end, thread) on the wall
clock in nanoseconds, the clock the profiler's events carry. With tracing
on it also runs ``torch.profiler`` over the window with the CUDA activity
alone, so the host pays for no operator events, and reduces the device
events (kernels, copies, sets) to the busy time, the longest idle gaps,
each named by the innermost host span over it, and the device operations
that took most time. The idle-share arithmetic is chip_smoke.py's
(1 - device busy / wall), with the busy time the union of the device
events' intervals so that overlapping streams count once.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Tuple

Interval = Tuple[int, int]


def union(intervals: List[Interval]) -> List[Interval]:
    """The sorted union of (start, end) intervals."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def idle_share(busy_s: float, window_s: float) -> float:
    return 1.0 - busy_s / window_s


class Recorder:
    """Host spans of one window and, with ``trace``, its device events."""

    def __init__(self, trace: bool, cuda: bool) -> None:
        self.trace = trace and cuda
        self.cuda = cuda
        self.spans: List[Tuple[str, int, int, int]] = []
        self._lock = threading.Lock()
        self._prof = None
        self.t0 = self.t1 = 0
        self.main = threading.get_ident()
        self.device_events: List[Tuple[str, int, int]] = []

    @contextmanager
    def span(self, key: str) -> Iterator[None]:
        t0 = time.time_ns()
        try:
            yield
        finally:
            t1 = time.time_ns()
            with self._lock:
                self.spans.append((key, t0, t1, threading.get_ident()))

    def __enter__(self) -> "Recorder":
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        self.main = threading.get_ident()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()
        self.t1 = time.time_ns()
        if self._prof is not None:
            self._prof.__exit__(*exc)
            self.device_events = _device_events(self._prof)
            self._prof = None

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def union_s(self, keys) -> float:
        """Seconds covered by the spans of ``keys`` on any thread, once."""
        return sum(e - s for s, e in union([(s, e) for k, s, e, _ in self.spans
                                             if k in keys])) / 1e9

    def nested(self, keys) -> List[Tuple[str, str]]:
        """(outer, inner) pairs of ``keys`` whose spans nest on one thread."""
        sel = sorted((s, -e, k, th) for k, s, e, th in self.spans if k in keys)
        found = set()
        open_: Dict[int, List[Tuple[int, str]]] = defaultdict(list)
        for s, neg_e, k, th in sel:
            stack = open_[th]
            while stack and stack[-1][0] <= s:
                stack.pop()
            if stack:
                found.add((stack[-1][1], k))
            stack.append((-neg_e, k))
        return sorted(found)

    def device_summary(self, top: int = 10) -> Optional[dict]:
        """busy_s, the top device operations and the longest idle gaps of
        the traced window; None without a trace."""
        if not self.device_events:
            return None
        busy = union([(s, e) for _, s, e in self.device_events])
        busy_s = sum(e - s for s, e in busy) / 1e9
        by_name: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device_events:
            by_name[name] += (e - s) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return {"busy_s": busy_s, "device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[self.label(g), (g[1] - g[0]) / 1e9] for g in gaps]}

    def label(self, gap: Interval) -> str:
        """What the host was doing at the gap's midpoint: the innermost span
        of the thread that runs the window, then, after " | ", the innermost
        span of any other thread (the cache writer's, say)."""
        mid = (gap[0] + gap[1]) // 2
        over = [(e - s, th != self.main, k) for k, s, e, th in self.spans if s <= mid <= e]
        main = [k for _, other, k in sorted(over) if not other][:1]
        rest = [k for _, other, k in sorted(over) if other][:1]
        return " | ".join(main + rest) or "host, no span"


def _device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every device event of a profiler session."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(_short(e.name()), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and e.duration_ns() > 0]


def _short(name: str) -> str:
    """A device operation's name without its return type, namespace
    decoration, template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    cuts = [i for i in (name.find("<"), name.find("(")) if i > 0]
    return (name[:min(cuts)] if cuts else name)[:96]
