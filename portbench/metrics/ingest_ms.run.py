"""Ingest: milliseconds a run in ``st_waveforms``' compute (the CSV parse
through the native decoder and the table's structure), from the program's
``plugin.st_waveforms.compute`` spans over the window."""


def read(run):
    runs = run.counts.get("runs")
    ms = run.rec.union_s({"plugin.st_waveforms.compute"}) * 1e3
    return ms / runs if runs and ms else None
