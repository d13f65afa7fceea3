"""The port's ``waveform-process`` CLI against the JAX package's.

Both CLIs run on the same synthetic VX2730 run (tests/utils.py
create_daq_run), the port's with ``--device cpu``: the CSV and parquet
exports of df_events and df_paired are equal (integer columns and the
integer cells of per-event arrays exactly, float columns and cells within
atol 1e-3 / rtol 1e-4); ``--scan-daq``, ``--show-daq`` and ``--preview``
print the same text; ``--preview`` computes nothing; a second invocation
loads from the cache; the exit codes of a missing run and a missing
``--run-name`` are the JAX CLI's; without a card the default device raises
and nothing runs on the CPU.
"""

import contextlib
import io
import json

import numpy as np
import pandas as pd
import pytest
import torch

from utils import create_daq_run
from waveformanalysis_tpu.cli import main as jax_main
from waveformanalysis_tpu_torch import cli
from waveformanalysis_tpu_torch.context.context import Context

ATOL, RTOL = 1e-3, 1e-4
RUN = "run_cli"


@pytest.fixture(scope="module")
def daq(tmp_path_factory):
    root = tmp_path_factory.mktemp("daq")
    create_daq_run(root / "DAQ", RUN, n_channels=2, n_rows=16, n_samples=48,
                   pulse_height=-300)
    return root


def run_cli(main, daq, storage, *extra, run=RUN, device=True):
    """(exit code, stdout, stderr) of one CLI call; the port's on the CPU."""
    args = ["--data-root", str(daq / "DAQ"), "--storage-dir", str(storage),
            "--n-channels", "2", "--quiet", *extra]
    if run is not None:
        args = ["--run-name", run, *args]
    if device and main is cli.main:
        args += ["--device", "cpu"]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(args)
    return rc, out.getvalue(), err.getvalue()


def cells(col: pd.Series) -> list:
    """Per-event array cells as arrays (a CSV holds them as numpy's text)."""
    return [np.asarray(c) if not isinstance(c, str)
            else np.fromstring(c.strip("[]"), sep=" ") for c in col]


def assert_frames_close(want: pd.DataFrame, got: pd.DataFrame) -> None:
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    for col in want.columns:
        a, b = want[col], got[col]
        if not pd.api.types.is_numeric_dtype(a):  # per-event arrays
            for x, y in zip(cells(a), cells(b)):
                assert x.shape == y.shape, col
                np.testing.assert_allclose(y, x, atol=ATOL, rtol=RTOL, err_msg=col)
        elif np.issubdtype(a.dtype, np.floating):
            assert b.dtype == a.dtype, col
            np.testing.assert_allclose(b, a, atol=ATOL, rtol=RTOL, err_msg=col)
        else:
            assert b.dtype == a.dtype, col
            np.testing.assert_array_equal(b, a, err_msg=col)


@pytest.mark.parametrize("suffix", ["csv", "parquet"])
@pytest.mark.parametrize("target", ["df_events", "df_paired"])
def test_export_equals_jax(daq, tmp_path, target, suffix):
    outs = {}
    for tag, main in (("jax", jax_main), ("port", cli.main)):
        path = tmp_path / tag / f"{target}.{suffix}"
        rc, out, _ = run_cli(main, daq, tmp_path / f"{tag}_store", "--target", target,
                             "--output", str(path))
        assert rc == 0 and out == f"wrote 16 rows to {path}\n"
        outs[tag] = pd.read_csv(path) if suffix == "csv" else pd.read_parquet(path)
    assert len(outs["port"]) == 16
    assert_frames_close(outs["jax"], outs["port"])


@pytest.mark.parametrize("flag", ["--scan-daq", "--show-daq"])
def test_daq_inspection_text_equals_jax(daq, tmp_path, flag):
    want, got = (run_cli(m, daq, tmp_path / "s", flag) for m in (jax_main, cli.main))
    assert got == want and want[0] == 0 and want[1]


def test_preview_equals_jax_and_computes_nothing(daq, tmp_path):
    want = run_cli(jax_main, daq, tmp_path / "jax", "--target", "df_events", "--preview")
    got = run_cli(cli.main, daq, tmp_path / "port", "--target", "df_events", "--preview")
    assert got == want and "df_events" in got[1]
    assert not [p for p in (tmp_path / "port").rglob("*") if p.is_file()]


def test_second_invocation_hits_the_cache(daq, tmp_path, monkeypatch):
    contexts = []
    init = Context.__init__

    def record(self, *args, **kwargs):
        init(self, *args, **kwargs)
        contexts.append(self)

    monkeypatch.setattr(Context, "__init__", record)
    outs = [tmp_path / "first.csv", tmp_path / "second.csv"]
    for out in outs:
        assert run_cli(cli.main, daq, tmp_path / "store", "--target", "df_events",
                       "--output", str(out))[0] == 0
    assert any(k.startswith("plugin.") for k in contexts[0].profiler.stats())
    assert not any(k.startswith("plugin.") for k in contexts[1].profiler.stats())
    assert outs[0].read_text() == outs[1].read_text()


@pytest.mark.parametrize("case", [
    ("missing_run", ["--target", "df"], "nope"),
    ("process_without_run_name", ["--target", "df"], None),
    ("show_daq_without_run_name", ["--show-daq"], None),
    ("scan_daq_missing_run", ["--scan-daq"], "nope"),
], ids=lambda c: c[0])
def test_exit_codes_equal_jax(daq, tmp_path, case):
    _, extra, run = case
    want, got = (run_cli(m, daq, tmp_path / "s", *extra, run=run)
                 for m in (jax_main, cli.main))
    assert got[0] == want[0] != 0
    assert got[2] == want[2]


def test_show_config_and_config_json(daq, tmp_path):
    """--show-config prints the resolved configs; --config-json feeds the
    Context (the JAX CLI's cases), and cannot pick the device."""
    rc, out, _ = run_cli(cli.main, daq, tmp_path / "s", "--show-config")
    assert rc == 0 and "data_root" in out
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"hit_threshold": {"threshold": 123.0}, "device": "cuda"}))
    rc, out, _ = run_cli(cli.main, daq, tmp_path / "s", "--target", "basic_features",
                         "--config-json", str(cfg))
    assert rc == 0 and out.startswith("basic_features: 32 rows computed")


def test_default_device_needs_a_card(daq, tmp_path, monkeypatch):
    """Without a card the default --device cuda raises before any Context
    exists: nothing runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    made = []
    monkeypatch.setattr(Context, "__init__", lambda self, *a, **k: made.append(self))
    for extra in (["--target", "df"], ["--scan-daq"]):
        with pytest.raises(RuntimeError, match="cuda"):
            run_cli(cli.main, daq, tmp_path / "s", *extra, device=False)
    assert made == [] and not (tmp_path / "s").exists()
    assert cli.build_parser().parse_args([]).device == "cuda"
