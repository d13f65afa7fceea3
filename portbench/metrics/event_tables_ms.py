"""Event layer: milliseconds a run in the event tables' computes (hit merge,
df, df_events, hit_grouped, df_paired), from the program's spans."""

KEYS = {"plugin.hit_merged.compute", "plugin.hit_merged_components.compute",
        "plugin.hit_merge_clusters.compute", "plugin.df.compute", "plugin.df_events.compute",
        "plugin.hit_grouped.compute", "plugin.df_paired.compute"}


def read(run):
    runs = run.counts.get("runs")
    ms = run.rec.union_s(KEYS) * 1e3
    return ms / runs if runs and ms else None
