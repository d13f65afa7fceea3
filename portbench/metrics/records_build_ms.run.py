"""Records: milliseconds a run in the records build (the decode of the run
files into parts, their merge, sort and pool gather) and its polarity
step, the union of the program's ``records.build`` and ``records.polarity``
spans over the window."""

KEYS = {"records.build", "records.polarity"}


def read(run):
    runs = run.counts.get("runs")
    ms = run.rec.union_s(KEYS) * 1e3
    return ms / runs if runs and ms else None
