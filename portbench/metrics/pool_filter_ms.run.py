"""Records: milliseconds a run in ``wave_pool_filtered``'s compute (the
pool's upload, each record length's gather, filter and scatter, and the
filtered pool's fetch), the program's ``plugin.wave_pool_filtered.compute``
spans over the window."""


def read(run):
    runs = run.counts.get("runs")
    ms = run.rec.union_s({"plugin.wave_pool_filtered.compute"}) * 1e3
    return ms / runs if runs and ms else None
