"""The records cell (``vx2730_records.tables``) on the CPU at a tiny size,
past the harness's look for a card, after the pattern of
``test_portbench_runs.py`` (whose ``test_program_agrees_with_the_reference``
runs this cell too): the control and each fault the cell can have (an
answer altered where it is produced, half of the run left out), in the
answers or planted in the program, come out as not correct, and a traced
run reads the records layer's metrics."""

import random
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 977
CELL = "vx2730_records.tables"


def tiny():
    """The cell's files with 512 records a run, as ``tiny()`` of
    ``test_portbench_runs.py`` sizes every kind but ``file_runs``."""
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    spec = harness.cell(manifest, CELL)
    spec.workload.update(events=512)
    return manifest, spec


def run(tmp_path, trace=False):
    manifest, spec = tiny()
    return harness.run_cell(CELL, SEED, 0.5, trace, "cpu", manifest=manifest,
                            workdir=str(tmp_path), spec=spec)


@pytest.fixture(scope="module")
def window(tmp_path_factory):
    _, spec = tiny()
    kind = harness.load_named("kinds", spec.workload["kind"])
    ref = harness.load_named("reference", spec.workload["kind"])
    from portbench.trace import Recorder

    d = kind.Driver(spec.config, spec.workload, SEED, torch.device("cpu"),
                    tmp_path_factory.mktemp("records"))
    try:
        d.setup()
        with Recorder(trace=False, cuda=False) as rec:
            d.window(0.2, rec)
        inputs = d.inputs()
        expected = ref.reference(inputs, spec.config, spec.workload, "cpu")
        return spec, ref, inputs, expected, d.answers(random.Random(SEED))
    finally:
        d.close()


def _fails(found, limits) -> bool:
    return any(v > float(limits[k]) for k, (v, _) in found.items())


def test_control_is_not_correct(window):
    spec, ref, inputs, expected, answers = window
    assert not _fails(ref.compare(expected, answers), spec.workload["limits"])
    control = ref.control(inputs, spec.config, spec.workload, "cpu")
    assert _fails(ref.compare(expected, control), spec.workload["limits"])


def _alter_one(tables):
    """One integer of the first table (records) moves by one."""
    t = dict(tables["records"])
    t["wave_offset"] = t["wave_offset"].copy()
    t["wave_offset"][-1] += 1
    tables["records"] = t


def _drop_half(tables):
    """Every table keeps its first half of rows (a pool its first half of samples)."""
    for key, t in list(tables.items()):
        tables[key] = (t.iloc[: len(t) // 2] if hasattr(t, "iloc")
                       else {c: v[: len(v) // 2] for c, v in t.items()})


@pytest.mark.parametrize("fault", [_alter_one, _drop_half], ids=["altered", "half_left_out"])
def test_faults_are_not_correct(window, fault):
    spec, ref, _, expected, answers = window
    planted = [(r, dict(tables)) for r, tables in answers]
    fault(planted[0][1])
    assert _fails(ref.compare(expected, planted), spec.workload["limits"])


def _shift_pad(real):
    """Each record read one sample late from the pool (an offset fault of
    the padded matrix)."""
    def padded(self, *a, **k):
        waves, lengths = real(self, *a, **k)
        waves = np.ascontiguousarray(waves)
        waves[:, :-1] = waves[:, 1:]
        return waves, lengths
    return padded


def _half_records(real):
    """The records bundle keeps its first half of records."""
    from waveformanalysis_tpu_torch.processing.records_builder import RecordsBundle

    def bundle(*a, **k):
        b = real(*a, **k)
        return RecordsBundle(records=b.records[: len(b.records) // 2], wave_pool=b.wave_pool)
    return bundle


@pytest.mark.parametrize("fault", ["altered", "half_left_out"])
def test_fault_under_the_timed_path_is_not_correct(fault, tmp_path, monkeypatch):
    """A fault planted in the program where the answers are made (the
    records' padded matrix, the records bundle) makes a whole run incorrect."""
    if fault == "altered":
        from waveformanalysis_tpu_torch.data.records_view import RecordsView

        monkeypatch.setattr(RecordsView, "padded_wave_matrix",
                            _shift_pad(RecordsView.padded_wave_matrix))
    else:
        from waveformanalysis_tpu_torch.plugins.builtin import records as R

        monkeypatch.setattr(R, "get_records_bundle", _half_records(R.get_records_bundle))
    res = run(tmp_path)
    assert not res["correct"]
    assert res["checks"]["exact_cells"]["value"] > 0 or res["checks"]["structure"]["value"] > 0


def test_traced_run_reads_the_records_layer(tmp_path):
    res = run(tmp_path, trace=True)
    assert res["correct"]
    # no device trace on the CPU: the device metrics stay out of the line
    assert not any(k.startswith("device_") for k in res["metrics"])
    assert {"records_build_ms.run", "records_pad_ms.run", "records_pad_mb.run",
            "pool_filter_ms.run", "records_members_ms.run", "saved_bytes_per_waveform.records",
            "event_tables_ms", "cache_writer_ms.run", "files_waveforms_per_s", "h2d_mb.run",
            "d2h_mb.run"} <= set(res["metrics"])
