#!/usr/bin/env python
"""Scaffold a plugin module of the port: schema, options, a device stage,
its plain twin and a parity test.

The twin of scripts/scaffold_plugin.py. The generated plugin follows the
port's idiom: ``kernel_config`` resolves the options, a ``device_stage``
of torch operations runs on the Context's device (the card unless the
Context is on the CPU), and a plain NumPy twin of the stage is what the
generated test holds the stage to, on the CPU and, where a card is
present, on the card.

    python scripts/scaffold_plugin_torch.py my_feature
    python scripts/scaffold_plugin_torch.py my_feature --out-dir DIR --test-dir DIR

Writes ``<out-dir>/<name>.py`` and ``<test-dir>/test_torch_<name>.py``;
refuses to overwrite an existing plugin file.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

PLUGIN_TEMPLATE = '''"""{provides} plugin."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from waveformanalysis_tpu_torch.device import to_device, to_numpy
from waveformanalysis_tpu_torch.dtypes.schema import Field, Schema
from waveformanalysis_tpu_torch.dtypes.table import Table
from waveformanalysis_tpu_torch.plugins.base import Option, Plugin

KERNEL_VERSION = "{provides}-v1"

{schema_const} = Schema(
    "{provides}",
    (
        Field("value", "f4", doc="TODO: describe"),
        Field("timestamp", "i8", unit="ps"),
        Field("channel", "i2"),
        Field("record_id", "i8"),
    ),
)


def {provides}_plain(waves: np.ndarray, lengths: np.ndarray, scale: float) -> np.ndarray:
    """The plain NumPy twin of the device stage: TODO, here ``scale`` times
    the peak-to-peak span of each event's valid samples (0 for none)."""
    out = np.zeros(len(waves), np.float32)
    for i, (w, n) in enumerate(zip(waves, lengths)):
        if n > 0:
            span = np.float32(w[:n].max()) - np.float32(w[:n].min())
            out[i] = np.float32(scale) * span
    return out


class {class_name}(Plugin):
    """TODO: one-line description."""

    provides = "{provides}"
    depends_on = ["{depends_on}"]
    description = "TODO"
    version = "0.1.0"
    kernel_version = KERNEL_VERSION
    save_when = "always"
    output_dtype = {schema_const}.numpy_dtype()
    options = {{
        "scale": Option(default=1.0, type=float, help="TODO"),
    }}

    def kernel_config(self, context: Any) -> dict:
        return {{"scale": float(context.get_config(self, "scale"))}}

    @staticmethod
    def device_stage(cfg: dict, waves_d: torch.Tensor, lengths_d: torch.Tensor) -> dict:
        """TODO: the device program, torch operations on the tensors' device."""
        w = waves_d.to(torch.float32)
        valid = torch.arange(w.shape[1], device=w.device)[None, :] < lengths_d[:, None]
        hi = torch.where(valid, w, -torch.inf).amax(dim=1)
        lo = torch.where(valid, w, torch.inf).amin(dim=1)
        value = torch.where(lengths_d > 0, (hi - lo) * cfg["scale"], 0.0)
        return {{"value": value.to(torch.float32)}}

    def compute(self, context: Any, run_id: str, **kwargs: Any) -> Table:
        data = context.get_data(run_id, "{depends_on}")
        if not isinstance(data, Table):
            data = Table.from_numpy(data)
        n = len(data)
        if n == 0:
            return Table.zeros(0, {schema_const})
        waves = np.asarray(data["wave"])
        lengths = (np.asarray(data["event_length"], np.int32) if "event_length" in data
                   else np.full(n, waves.shape[1], np.int32))
        out = self.device_stage(self.kernel_config(context),
                                to_device(waves, context.device),
                                to_device(lengths, context.device))
        return Table(
            {{
                "value": to_numpy(out["value"]),
                "timestamp": np.asarray(data["timestamp"], np.int64),
                "channel": np.asarray(data["channel"], np.int16),
                "record_id": np.asarray(data["record_id"], np.int64),
            }},
            schema={schema_const},
        )
'''

TEST_TEMPLATE = '''"""Tests for the {provides} plugin: its device stage against the plain
twin, on the CPU and (where present) on the card, and the plugin through a
Context."""
{import_block}
import numpy as np
import pytest
import torch

from waveformanalysis_tpu_torch.device import to_numpy
from waveformanalysis_tpu_torch.testing.fixtures import (
    make_fake_st_waveforms,
    make_tiny_context,
)

# the card's cases carry the cuda marker and skip without a card
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def need(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.parametrize("device", DEVICES)
def test_{provides}_device_stage_equals_plain(device):
    need(device)
    rng = np.random.default_rng(0)
    waves = rng.integers(0, 4000, (64, 96)).astype(np.int16)
    lengths = rng.integers(0, 97, 64).astype(np.int32)
    cfg = {{"scale": 0.5}}
    out = {class_name}.device_stage(cfg, torch.from_numpy(waves).to(device),
                                    torch.from_numpy(lengths).to(device))
    np.testing.assert_array_equal(to_numpy(out["value"]),
                                  {provides}_plain(waves, lengths, cfg["scale"]))


@pytest.mark.parametrize("device", DEVICES)
def test_{provides}_runs(tmp_path, device):
    need(device)
    st = make_fake_st_waveforms(8, 64)
    with make_tiny_context(tmp_path, st_waveforms=st, config={{"device": device}}) as ctx:
        ctx.register({class_name}())
        out = ctx.get_data("test_run", "{provides}")
    assert len(out) == 8
    waves = np.asarray(st["wave"])
    np.testing.assert_array_equal(
        to_numpy(out["value"]),
        {provides}_plain(waves, np.full(8, waves.shape[1], np.int32), 1.0))
'''


def import_block(out: Path, provides: str, class_name: str) -> str:
    """The test's import of the plugin: by module path where the plugin
    lies in a package of the repo, else from the plugin's directory."""
    names = f"{class_name}, {provides}_plain"
    out = out.resolve()
    try:
        parts = out.relative_to(REPO).with_suffix("").parts
    except ValueError:
        parts = ()
    if parts and all((REPO.joinpath(*parts[:i]) / "__init__.py").is_file()
                     for i in range(1, len(parts))):
        return f"\nfrom {'.'.join(parts)} import {names}\n"
    return (f"\nimport sys\n\nsys.path.insert(0, {str(out.parent)!r})\n"
            f"from {out.stem} import {names}  # noqa: E402\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("provides", help="Data name the plugin provides")
    p.add_argument("--depends-on", default="st_waveforms")
    p.add_argument("--out-dir", default=str(REPO / "waveformanalysis_tpu_torch" / "plugins"
                                            / "builtin"))
    p.add_argument("--test-dir", default=str(REPO / "tests"))
    args = p.parse_args(argv)

    provides = args.provides
    if not provides.isidentifier():
        print(f"error: {provides!r} is not a Python identifier", file=sys.stderr)
        return 1
    class_name = "".join(w.capitalize() for w in provides.split("_")) + "Plugin"
    schema_const = provides.upper() + "_SCHEMA"

    out = Path(args.out_dir) / f"{provides}.py"
    if out.exists():
        print(f"error: {out} already exists", file=sys.stderr)
        return 1
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(PLUGIN_TEMPLATE.format(
        provides=provides, class_name=class_name,
        depends_on=args.depends_on, schema_const=schema_const,
    ))
    test = Path(args.test_dir) / f"test_torch_{provides}.py"
    test.parent.mkdir(parents=True, exist_ok=True)
    test.write_text(TEST_TEMPLATE.format(
        provides=provides, class_name=class_name,
        import_block=import_block(out, provides, class_name),
    ))
    print(f"created {out} and {test}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
