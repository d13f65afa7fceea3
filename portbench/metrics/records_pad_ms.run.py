"""Records: milliseconds a run in building the records source's padded wave
matrices (each record's samples at its offset in the pool, zero past its
length), the union of the program's ``records.pad`` spans over the window.
A program without the span gives no value."""


def read(run):
    runs = run.counts.get("runs")
    ms = run.rec.union_s({"records.pad"}) * 1e3
    return ms / runs if runs and ms else None
