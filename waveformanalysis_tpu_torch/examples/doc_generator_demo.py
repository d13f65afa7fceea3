"""PluginDocGenerator: render plugin reference docs from a live Context.

    python -m waveformanalysis_tpu_torch.examples.doc_generator_demo [--device cuda]

The port's counterpart of the JAX package's examples/doc_generator_demo.py
(reference analog: examples/demo_doc_generator.py, whose DocGenerator
emits api/config/plugin references; these pages fold the option/config
tables into each plugin page). Generates one markdown page per registered
plugin plus an index table -- the same generator ``python -m
waveformanalysis_tpu_torch.utils.cli_docs`` drives from the command line.
The Context is built on ``--device`` (default ``cuda``, which raises
without a card; ``--device cpu`` on the CPU); rendering computes nothing.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path
from typing import Any, Dict


def main(device: str = "cuda") -> Dict[str, Any]:
    """Run the demo; returns the page's first line, the files written and
    the coverage report."""
    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.plugins.plugin_sets import cuda_default
    from waveformanalysis_tpu_torch.utils.plugin_doc_generator import (
        PluginDocGenerator,
        check_doc_coverage,
    )

    with tempfile.TemporaryDirectory() as tmp:
        ctx = Context(storage_dir=str(Path(tmp) / "store"),
                      config={"show_progress": False, "device": device})
        print(f"device: {ctx.device}")
        ctx.register(*cuda_default())
        gen = PluginDocGenerator(ctx)

        # -- 1. one page, human variant ------------------------------------
        page = gen.render_plugin("hit")
        print(page.splitlines()[0])
        print(f"... ({len(page.splitlines())} lines)")

        # -- 2. the index table ----------------------------------------------
        index = gen.render_index()
        print("\nindex head:")
        print("\n".join(index.splitlines()[:6]))

        # -- 3. everything at once -------------------------------------------
        out_dir = Path(tmp) / "docs"
        written = gen.generate_all(out_dir)
        print(f"\nwrote {len(written)} files to {out_dir}")

        # -- 4. the coverage check CI runs -----------------------------------
        report = check_doc_coverage(ctx, out_dir)
        print("coverage report:", report)
    return {"first_line": page.splitlines()[0], "written": len(written), "report": report}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=parser.parse_args().device)
