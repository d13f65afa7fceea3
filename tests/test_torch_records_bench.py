"""The benchmark's records cell (``vx2730_records.tables``) on the CPU at
1,024 records, 512 a channel at record lengths 256 and 400.

One run of the cell's kind (``portbench/kinds/records_runs.py``) over its
configuration: its answers, read back from the cache, equal the plain
reference (``portbench/reference/records_runs.py``) on every compared
table; the reference in bfloat16 and faults planted in the answers do not;
the window's log holds the records layer's spans and counts, and every
per-layer metric reader of the records layer reads a value. Then the
repair the ragged run asked for: an integral width's total charge is the
record's own, whatever its row is padded to.
"""

import random
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.trace import Recorder

ROOT = Path(__file__).resolve().parents[1]
CELL = "vx2730_records.tables"
SEED = 2**31 + 977
RECORDS = 1024
NEW_METRICS = ("records_build_ms.run", "records_pad_ms.run", "records_pad_mb.run",
               "pool_filter_ms.run", "records_members_ms.run",
               "saved_bytes_per_waveform.records")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch's ops on one thread: the file's many small ops wait on one
    another's threads when the suite's other workers hold every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cell_run(tmp_path_factory, one_thread):
    """(spec, reference module, inputs, expected, answers, run, the run
    files' directory) of one window of the cell at RECORDS records."""
    spec = harness.cell(harness.load_json(ROOT / "BENCHMARK.json"), CELL)
    spec.workload["events"] = RECORDS
    kind = harness.load_named("kinds", spec.workload["kind"])
    ref = harness.load_named("reference", spec.workload["kind"])
    d = kind.Driver(spec.config, spec.workload, SEED, torch.device("cpu"),
                    tmp_path_factory.mktemp("records_cell"))
    try:
        d.setup()
        with Recorder(trace=False, cuda=False) as rec:
            out = d.window(0.2, rec)
        answers = d.answers(random.Random(SEED))
        inputs = d.inputs()
    finally:
        d.close()
    run = SimpleNamespace(rec=rec, device=None, window_s=rec.window_s, counts=out["counts"],
                          workload=spec.workload, config=spec.config)
    expected = ref.reference(inputs, spec.config, spec.workload, "cpu")
    return spec, ref, inputs, expected, answers, run, d.daq


def fails(found, limits) -> bool:
    return any(v > float(limits[k]) for k, (v, _) in found.items())


def test_records_cell_agrees_with_the_reference(cell_run):
    spec, ref, inputs, expected, answers, _, _ = cell_run
    assert [len(w) for w in inputs["waves"]] == [RECORDS // 2] * 2
    assert [w.shape[1] for w in inputs["waves"]] == [256, 400]
    assert answers and all(set(t) == set(spec.workload["compared"]) for _, t in answers)
    found = ref.compare(expected, answers)
    assert {k: v for k, (v, _) in found.items()} == {"structure": 0, "exact_cells": 0,
                                                     "f32_gap": found["f32_gap"][0]}
    assert not fails(found, spec.workload["limits"]), found


def test_records_cell_control_is_not_correct(cell_run):
    spec, ref, inputs, expected, _, _, _ = cell_run
    control = ref.control(inputs, spec.config, spec.workload, "cpu")
    assert fails(ref.compare(expected, control), spec.workload["limits"])


def _one_record_integer(tables):
    t = tables["records"]
    t["event_length"] = t["event_length"].copy()
    t["event_length"][0] += 1


def _half_of_df_paired(tables):
    t = tables["df_paired"]
    tables["df_paired"] = t.iloc[: len(t) // 2]


@pytest.mark.parametrize("fault", [_one_record_integer, _half_of_df_paired],
                         ids=["one_record_integer", "half_of_df_paired"])
def test_records_cell_faults_are_not_correct(cell_run, fault):
    spec, ref, _, expected, answers, _, _ = cell_run
    planted = [(run, dict(tables)) for run, tables in answers]
    planted[0] = (planted[0][0], {k: (dict(v) if isinstance(v, dict) else v.copy())
                                  for k, v in planted[0][1].items()})
    fault(planted[0][1])
    assert fails(ref.compare(expected, planted), spec.workload["limits"])
    assert not fails(ref.compare(expected, answers), spec.workload["limits"])


def test_records_window_logs_the_records_spans_and_counts(cell_run):
    from waveformanalysis_tpu_torch.foundation import profiler

    run = cell_run[5]
    spans = {s.key for s in profiler.spans(run.rec.t0, run.rec.t1)}
    counts = {}
    for c in profiler.counts(run.rec.t0, run.rec.t1):
        counts[c.key] = counts.get(c.key, 0) + c.n
    assert {"records.pad", "records.build", "records.decode", "records.polarity"} <= spans
    runs = run.counts["runs"]
    pool = sum(RECORDS // 2 * L for L in (256, 400))
    assert counts["records.pool_samples"] == runs * pool
    # two padded matrices a run: int16 for the fused members, float32 (the
    # filtered pool) for hit, each 512 samples wide
    assert counts["records.pad_rows"] == runs * 2 * RECORDS
    assert counts["records.pad_bytes"] == runs * RECORDS * 512 * (2 + 4)
    files = sum(f.stat().st_size for f in (Path(cell_run[6]) / "seed" / "RAW").iterdir())
    assert counts["records.decode_bytes"] == runs * files


@pytest.mark.parametrize("name", NEW_METRICS)
def test_records_metric_readers_read_a_cpu_run(cell_run, name):
    value = harness.load_named("metrics", name).read(cell_run[5])
    assert value is not None and value > 0


def test_integral_width_total_is_the_records_own():
    """Repair: the port's integral width took a record's total charge at the
    end of its padded row. The blocked float32 prefix sums reach a row's
    last padded sample by another association than its own last sample, so
    at records of 256 and 400 samples padded to 512 the total differed in
    its last bit for about a sixth of the 400-sample records, and a
    quantile target could move a crossing by a sample. The total is now
    each record's own, equal to the plain reference's at its true length."""
    from portbench.gen import generator, make_batch
    from portbench.reference.plain.integral_width import integral_quantile_width as plain
    from waveformanalysis_tpu_torch.ops.widths import integral_quantile_width

    gen = generator(5, "cpu")
    rows = [make_batch(2048, L, gen).to(torch.float32) for L in (256, 400)]
    padded = torch.zeros((4096, 512))
    padded[:2048, :256] = rows[0] - 1000.3
    padded[2048:, :400] = rows[1] - 1000.3
    lengths = torch.tensor([256] * 2048 + [400] * 2048, dtype=torch.int32)
    got = integral_quantile_width(padded, lengths)
    for i, L in enumerate((256, 400)):
        want = plain(rows[i] - 1000.3, 0.1, 0.9)
        part = slice(i * 2048, (i + 1) * 2048)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k][part].numpy(), v.numpy(), err_msg=f"{k} L={L}")
