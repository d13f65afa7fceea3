"""Storage: milliseconds a run in which the cache writer was busy, the union
of the program's ``context.save_cache`` spans on every writer thread (which
covers the window's final flush, the wait for the last saves)."""


def read(run):
    runs = run.counts.get("runs")
    ms = run.rec.union_s({"context.save_cache"}) * 1e3
    return ms / runs if runs and ms else None
