"""Filter and members: milliseconds a run in the SG filter plugin, the fused
executor's phases and the members computed on their own (the plan decides
which members are fused: with the event layer requested, basic_features and
hit_threshold are), from the program's spans (their union, so that a span
inside another counts once)."""

KEYS = {"plugin.filtered_waveforms.compute", "fusion.single.load", "fusion.single.upload",
        "fusion.single.device_program", "fusion.single.fetch", "fusion.single.finalize",
        "plugin.basic_features.compute", "plugin.hit_threshold.compute",
        "plugin.hit.compute", "plugin.waveform_width.compute", "plugin.s1_s2.compute"}


def read(run):
    runs = run.counts.get("runs")
    ms = run.rec.union_s(KEYS) * 1e3
    return ms / runs if runs and ms else None
