"""Config management: scoping, precedence, lineage-driven cache invalidation.

    python -m waveformanalysis_tpu_torch.examples.config_management_example [--device cuda]

The port's counterpart of the JAX package's
examples/config_management_example.py (reference analog:
examples/config_management_example.py,
examples/list_plugin_configs_example.py). Shows the resolver's precedence
(plugin-scoped dict > dotted key > global > adapter-inferred > default),
how plugin-scoped set_config merges one level, and that changing a tracked
option rotates the lineage key -- so caches invalidate exactly when results
could differ. ``hit`` runs on ``--device`` (default ``cuda``; ``--device
cpu`` runs on the CPU).
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Any, Dict

from waveformanalysis_tpu_torch.testing.fixtures import make_fake_st_waveforms


def main(device: str = "cuda") -> Dict[str, Any]:
    """Run the example; returns the resolved values and whether the key
    rotated."""
    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.plugins.builtin.basic_features import BasicFeaturesPlugin
    from waveformanalysis_tpu_torch.plugins.builtin.peak_finding import HitFinderPlugin

    with tempfile.TemporaryDirectory() as tmp:
        ctx = Context(storage_dir=tmp, config={"show_progress": False, "device": device})
        print(f"device: {ctx.device}")
        ctx.register(BasicFeaturesPlugin(), HitFinderPlugin())
        ctx.inject_data("r", "st_waveforms",
                        make_fake_st_waveforms(n_events=64))

        # ---- discovering options --------------------------------------
        print(ctx.help("hit"))

        # ---- scoped configuration -------------------------------------
        # plugin-scoped dict beats dotted key beats global key
        ctx.set_config({"hit": {"height": 50.0}})       # plugin-scoped
        ctx.set_config({"hit.distance": 4})              # dotted
        ctx.set_config({"prominence": 1.0})              # global fallback
        cfg = ctx._plugins["hit"].validate_config(ctx)
        resolved = {k: cfg[k] for k in ("height", "distance", "prominence")}
        print(f"resolved: height={cfg['height']} distance={cfg['distance']} "
              f"prominence={cfg['prominence']}")

        # scoped dicts MERGE one level: height survives this update
        ctx.set_config({"hit": {"width": 3}})
        cfg = ctx._plugins["hit"].validate_config(ctx)
        assert cfg["height"] == 50.0 and cfg["width"] == 3

        # ---- lineage + cache invalidation ------------------------------
        key_before = ctx.key_for("r", "hit")
        ctx.get_data("r", "hit")
        ctx.set_config({"hit": {"height": 80.0}})  # tracked option changes
        key_after = ctx.key_for("r", "hit")
        print(f"lineage key rotated: {key_before != key_after}")
        assert not ctx.cache_domain.is_cache_hit("r", "hit")

        # untracked/display options do NOT rotate lineage
        ctx.set_config({"show_progress": True})
        assert ctx.key_for("r", "hit") == key_after
        ctx.flush_saves()
    return {"resolved": resolved, "rotated": key_before != key_after,
            "keys": (key_before, key_after)}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=parser.parse_args().device)
