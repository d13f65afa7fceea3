"""waveform-process CLI: run the full pipeline on a DAQ run.

Behavioral analog of the reference main CLI
(reference: waveform_analysis/cli.py:23-230): scan/inspect a DAQ run,
register a profile, compute ``df_paired`` (or another target), and export
CSV/Parquet.

Port of ``waveformanalysis_tpu/cli.py``, run as
``python -m waveformanalysis_tpu_torch.cli``. The JAX CLI's ``--platform``
becomes ``--device {cuda,cpu}`` (default ``cuda``): it goes into the
Context's ``config["device"]``, and without a card the default raises
instead of running on the CPU. ``--profile`` takes the port's profile
names (default ``cuda``). The other flags, exit codes and messages are the
JAX CLI's.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, List, Optional

import numpy as np

from waveformanalysis_tpu_torch.device import resolve_device
from waveformanalysis_tpu_torch.plugins.plugin_sets import PROFILES, get_profile

# Patchable metadata source, mirroring the package facade
# (reference: waveform_analysis/cli.py version flag).
from importlib.metadata import PackageNotFoundError, version as package_version


def _pkg_version() -> str:
    try:
        return package_version("waveformanalysis-tpu")
    except PackageNotFoundError:
        from waveformanalysis_tpu_torch import __version__

        return __version__


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="waveform-process",
        description="PyTorch/CUDA DAQ waveform processing pipeline",
    )
    p.add_argument("--version", action="version",
                   version=f"%(prog)s {_pkg_version()}")
    p.add_argument("--run-name", required=False, help="Run directory name")
    p.add_argument("--data-root", default="DAQ", help="Data root directory")
    p.add_argument("--storage-dir", default=None,
                   help="Cache/storage directory (default: <data-root>/_storage)")
    p.add_argument("--daq-adapter", default="vx2730",
                   help="DAQ adapter name (vx2730, v1725, ...)")
    p.add_argument("--n-channels", type=int, default=None,
                   help="Number of channels to process")
    p.add_argument("--start-channel", type=int, default=None,
                   help="First paired-column channel index (reference CLI "
                        "parity: its --start-channel feeds the global "
                        "start_channel_slice, default 6)")
    p.add_argument("--time-window", type=float, default=None,
                   help="Event grouping window (ns)")
    p.add_argument("--profile", default="cuda", choices=sorted(PROFILES),
                   help="Plugin profile to register (reference CLI parity: "
                        "cpu | streaming work here)")
    p.add_argument("--target", default="df_paired",
                   help="Data name to compute (default df_paired)")
    p.add_argument("--output", default=None,
                   help="Output file (.csv or .parquet) for DataFrame targets")
    p.add_argument("--config-json", default=None,
                   help="Extra context config as a JSON file or inline JSON")
    p.add_argument("--scan-daq", action="store_true",
                   help="Scan the run directory and exit")
    p.add_argument("--show-daq", action="store_true",
                   help="Show DAQ run overview and exit")
    p.add_argument("--show-config", action="store_true",
                   help="Show resolved plugin configs and exit")
    p.add_argument("--preview", action="store_true",
                   help="Show the execution plan / cache status and exit")
    p.add_argument("--quiet", action="store_true", help="Suppress progress output")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device of the device programs (default cuda; "
                        "raises when no card is present, never falls back)")
    return p


def _load_extra_config(arg: Optional[str]) -> dict:
    if not arg:
        return {}
    path = Path(arg)
    if path.exists():
        with open(path) as fh:
            return json.load(fh)
    return json.loads(arg)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)

    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.formats.adapter import get_adapter

    config: dict = {
        "data_root": args.data_root,
        "daq_adapter": args.daq_adapter,
        "show_progress": not args.quiet,
    }
    if args.n_channels is not None:
        config["n_channels"] = args.n_channels
    if args.start_channel is not None:
        # the reference CLI (cli.py:52,146) forwards this to the GLOBAL
        # start_channel_slice key; 0 is a legal value (was dropped by a
        # truthiness test before r5)
        config["start_channel_slice"] = args.start_channel
    if args.time_window is not None:
        config["time_window_ns"] = args.time_window
    config.update(_load_extra_config(args.config_json))
    config["device"] = args.device  # the flag alone picks the device

    # DAQ inspection modes don't need a Context
    if args.scan_daq or args.show_daq:
        if not args.run_name:
            print("error: --run-name is required for DAQ inspection", file=sys.stderr)
            return 2
        adapter = get_adapter(args.daq_adapter)
        try:
            groups = adapter.scan_run_detailed(args.data_root, args.run_name)
        except FileNotFoundError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        if args.scan_daq:
            for ch in sorted(groups):
                files = groups[ch]
                total = sum(f["size"] for f in files)
                print(f"channel {ch}: {len(files)} files, {total / 1e6:.2f} MB")
            return 0
        from waveformanalysis_tpu_torch.utils.daq import DAQRun

        run = DAQRun(args.data_root, args.run_name, adapter=adapter)
        print(run.overview())
        return 0

    storage_dir = args.storage_dir or str(Path(args.data_root) / "_storage")
    ctx = Context(storage_dir=storage_dir, config=config)
    ctx.register(*get_profile(args.profile))

    if args.time_window is not None:
        ctx.set_config({
            "df_events": {"time_window_ns": args.time_window},
            "df_paired": {"time_window_ns": args.time_window},
        })

    if args.show_config:
        for name in ctx.list_data_names():
            resolved = ctx.get_resolved_config(name)
            print(resolved.summary(verbose=True))
            print()
        return 0

    if not args.run_name:
        print("error: --run-name is required to process data", file=sys.stderr)
        return 2

    if args.preview:
        ctx.preview_execution(args.run_name, args.target, verbose=True)
        return 0

    try:
        result = ctx.get_data(args.run_name, args.target)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    # export
    if args.output:
        out_path = Path(args.output)
        df = _to_dataframe(result)
        if df is None:
            print(f"error: target '{args.target}' is not exportable as a table",
                  file=sys.stderr)
            return 1
        out_path.parent.mkdir(parents=True, exist_ok=True)
        if out_path.suffix.lower() == ".parquet":
            _write_parquet(df, out_path)
        else:
            df.to_csv(out_path, index=False)
        print(f"wrote {len(df)} rows to {out_path}")
    else:
        n = len(result) if hasattr(result, "__len__") else "?"
        print(f"{args.target}: {n} rows computed (run {args.run_name})")
        if not args.quiet:
            print(ctx.get_performance_report())
    return 0


def _to_dataframe(result: Any):
    import pandas as pd

    from waveformanalysis_tpu_torch.dtypes.table import Table

    if isinstance(result, pd.DataFrame):
        return result
    if isinstance(result, Table):
        host = result.to_host()
        return pd.DataFrame({
            k: (list(v) if getattr(v, "ndim", 1) > 1 else v)
            for k, v in host.columns.items()
        })
    if hasattr(result, "dtype") and getattr(result.dtype, "names", None):
        return pd.DataFrame({n: result[n] for n in result.dtype.names
                             if result.dtype[n].shape == ()})
    return None


def _write_parquet(df: Any, path: Path) -> None:
    try:
        df.to_parquet(path)
    except Exception:
        # object columns (per-event arrays) are not parquet-friendly; stringify
        df2 = df.copy()
        for col in df2.columns:
            if df2[col].dtype == object:
                df2[col] = df2[col].apply(
                    lambda x: json.dumps(np.asarray(x).tolist())
                    if hasattr(x, "__len__") else x
                )
        df2.to_parquet(path)


if __name__ == "__main__":
    sys.exit(main())
