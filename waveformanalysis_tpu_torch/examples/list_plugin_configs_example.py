"""Context.list_plugin_configs(): the option catalogue.

    python -m waveformanalysis_tpu_torch.examples.list_plugin_configs_example [--device cuda]

The port's counterpart of the JAX package's
examples/list_plugin_configs_example.py (reference analog:
examples/list_plugin_configs_example.py):

1. every registered plugin's options (default / current / modified flag),
2. how set_config changes show up,
3. single-plugin filtering and programmatic access.

The Context is built on ``--device`` (default ``cuda``, which raises
without a card; ``--device cpu`` on the CPU); listing options computes
nothing.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Any, Dict


def main(device: str = "cuda") -> Dict[str, Any]:
    """Run the example; returns the hit plugin's catalogue entry summary."""
    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.plugins.builtin.basic_features import (
        BasicFeaturesPlugin,
    )
    from waveformanalysis_tpu_torch.plugins.builtin.peak_finding import HitFinderPlugin

    with tempfile.TemporaryDirectory() as tmp:
        ctx = Context(storage_dir=tmp, config={"show_progress": False, "device": device})
        print(f"device: {ctx.device}")
        ctx.register(BasicFeaturesPlugin(), HitFinderPlugin())

        print("=" * 70)
        print("1. all plugins, defaults")
        print("=" * 70)
        ctx.list_plugin_configs()

        print()
        print("=" * 70)
        print("2. after set_config (see the * markers)")
        print("=" * 70)
        ctx.set_config({"hit": {"height": 123.0, "prominence": 9.0}})
        ctx.list_plugin_configs(plugin_name="hit")

        print()
        print("=" * 70)
        print("3. programmatic access (verbose=False)")
        print("=" * 70)
        info = ctx.list_plugin_configs(verbose=False)
        hit_opts = info["hit"]["options"]
        modified = {k: v["current_value"] for k, v in hit_opts.items()
                    if not v["is_default"]}
        print(f"hit v{info['hit']['version']}: {len(hit_opts)} options, "
              f"modified: {modified}")
    return {"plugins": sorted(info), "hit_options": len(hit_opts), "modified": modified}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=parser.parse_args().device)
