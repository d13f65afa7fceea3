"""Filter and members: milliseconds a run in the members over the records
source: the fused executor's phases and the members computed on their own
(with the event layer requested, hit runs alone over the filtered pool and
the rest fused over the pool), the union of the program's spans below."""

KEYS = {"fusion.single.load", "fusion.single.upload", "fusion.single.device_program",
        "fusion.single.fetch", "fusion.single.finalize", "plugin.basic_features.compute",
        "plugin.hit.compute", "plugin.hit_threshold.compute",
        "plugin.waveform_width_integral.compute", "plugin.df.compute"}


def read(run):
    runs = run.counts.get("runs")
    ms = run.rec.union_s(KEYS) * 1e3
    return ms / runs if runs and ms else None
