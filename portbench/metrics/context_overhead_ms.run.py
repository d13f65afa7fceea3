"""Context: milliseconds a run of the Context's own time: the part of the
outermost ``context.get_data`` spans on the window's thread that no span
read by ``ingest_ms.run``, ``members_ms.run`` or ``event_tables_ms`` covers
(planning, each plugin's contract and save enqueue, the release of the
device columns, the cache checks), from the program's log."""

from portbench.harness import load_named
from portbench.program_log import uncovered_s, window

INGEST = {"plugin.st_waveforms.compute"}  # ingest_ms.run's span


def read(run):
    log = window(run)
    if log is None:
        return None
    spans, _ = log
    main = run.rec.main
    layers = (INGEST | load_named("metrics", "members_ms.run").KEYS
              | load_named("metrics", "event_tables_ms").KEYS)
    requests = [(s.start_ns, s.end_ns) for s in spans
                if s.key == "context.get_data" and s.thread == main]
    inside = [(s.start_ns, s.end_ns) for s in spans if s.key in layers and s.thread == main]
    if not requests:
        return None
    return uncovered_s(requests, inside) * 1e3 / run.counts["runs"]
