"""Verify the signal-processing lineage wiring end to end.

    python -m waveformanalysis_tpu_torch.examples.verify_lineage_demo [--device cuda]

The port's counterpart of the JAX package's examples/verify_lineage_demo.py.
Walks the checks the reference's verification script performs
(examples/verify_signal_processing_lineage.py): plugin registration, the
dependency chain under the resolved wave source, per-plugin resolved
configs, lineage hashing (tracked options in, untracked out, key changes on
config changes), and the lineage plot hook (``Context.plot_lineage``; the
plot is skipped where matplotlib is not installed). The Context is built
on ``--device`` (default ``cuda``, which raises without a card; ``--device
cpu`` on the CPU).
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Any, Dict

from waveformanalysis_tpu_torch.testing.fixtures import make_fake_st_waveforms


def verify_registration(ctx) -> list:
    print("=" * 70)
    print("1. plugin registration")
    print("=" * 70)
    names = sorted(ctx.plugins)
    print(f"{len(names)} plugins: {', '.join(names)}")
    assert "hit" in names and "s1_s2" in names
    return names


def verify_dependency_chain(ctx, run_id) -> None:
    print("\n" + "=" * 70)
    print("2. dependency chain (resolved wave source)")
    print("=" * 70)

    def show(name, level=1):
        plugin = ctx.get_plugin(name)
        if plugin is None:
            print("  " * level + f"{name} (source data)")
            return
        deps = ctx.resolve_depends_on(plugin, run_id) \
            if hasattr(ctx, "resolve_depends_on") else plugin.depends_on
        print("  " * level + f"{name} <- {deps}")
        for d in deps:
            show(d, level + 1)

    show("s1_s2")


def verify_configs(ctx) -> None:
    print("\n" + "=" * 70)
    print("3. resolved configs (tracked vs untracked)")
    print("=" * 70)
    plugin = ctx.get_plugin("hit")
    tracked = [k for k, o in plugin.options.items() if o.track]
    untracked = [k for k, o in plugin.options.items() if not o.track]
    resolved = ctx.get_resolved_config("hit")
    print(f"hit: {len(tracked)} tracked, {len(untracked)} untracked "
          f"(untracked: {untracked})")
    print(f"resolved {len(resolved.values)} values "
          f"(e.g. height from {resolved.values['height'].source.value})")
    assert "height" in tracked


def verify_lineage_tracking(ctx, run_id) -> tuple:
    print("\n" + "=" * 70)
    print("4. lineage hashing")
    print("=" * 70)
    lineage = ctx.get_lineage("hit")
    print(f"lineage nodes: {sorted(lineage)}")
    key0 = ctx.key_for(run_id, "hit")
    ctx.set_config({"hit": {"height": 222.0}})  # tracked -> key changes
    key1 = ctx.key_for(run_id, "hit")
    ctx.set_config({"hit": {"overflow_policy": "warn"}})
    ctx.set_config({"hit": {"n_workers": 4}})  # untracked -> key stable
    key2 = ctx.key_for(run_id, "hit")
    print(f"key(default)={key0} key(height=222)={key1} key(+untracked)={key2}")
    assert key0 != key1, "tracked option must change the lineage key"
    assert key1 == key2, "untracked option must NOT change the lineage key"
    return key0, key1, key2


def visualize_lineage(ctx) -> str:
    print("\n" + "=" * 70)
    print("5. lineage plot hook")
    print("=" * 70)
    if not hasattr(ctx, "plot_lineage"):
        print("! Context has no plot_lineage")
        return "missing"
    try:
        import matplotlib

        matplotlib.use("Agg")
        fig = ctx.plot_lineage("hit")
        print(f"plot_lineage('hit') -> {type(fig).__name__}")
        return type(fig).__name__
    except Exception as exc:  # matplotlib optional in minimal installs
        print(f"plot skipped: {exc}")
        return "skipped"


def main(device: str = "cuda") -> Dict[str, Any]:
    """Run the checks; returns the plugins, the three keys and the plot's
    type (or "skipped")."""
    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.plugins.plugin_sets import cuda_default

    with tempfile.TemporaryDirectory() as tmp:
        ctx = Context(storage_dir=tmp, config={"show_progress": False, "device": device})
        print(f"device: {ctx.device}")
        ctx.register(*cuda_default())
        run_id = "run_001"
        ctx.inject_data(run_id, "st_waveforms", make_fake_st_waveforms(
            n_events=32, wave_length=64, n_channels=2, pulse_start=20,
            pulse_width=6, pulse_height=250, noise_rms=2.0, seed=4,
        ))
        names = verify_registration(ctx)
        verify_dependency_chain(ctx, run_id)
        verify_configs(ctx)
        keys = verify_lineage_tracking(ctx, run_id)
        plot = visualize_lineage(ctx)
        print("\nall lineage checks passed")
    return {"plugins": names, "keys": keys, "plot": plot}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=parser.parse_args().device)
