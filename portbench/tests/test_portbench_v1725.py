"""The V1725 DAW cell (``v1725_records.tables``) on the CPU at 512 records,
32 interactions over all 16 channels, after the pattern of
``test_portbench_records.py`` (``test_portbench_runs.py``'s
``test_program_agrees_with_the_reference`` runs this cell too): the
writer's files read back through the port's V1725 readers give the arrays
it wrote; the control and two faults planted in the program (one record's
polarity flipped, one record's length off by 2) come out as not correct;
a traced run reads the three metrics this cell brought, one filter batch
a (channel, length) pair; the reference and the generator import nothing
of the program."""

import ast
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 977
CELL = "v1725_records.tables"
RECORDS = 512


def tiny():
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    spec = harness.cell(manifest, CELL)
    spec.workload.update(events=RECORDS)
    return manifest, spec


def run(tmp_path, trace=False):
    manifest, spec = tiny()
    return harness.run_cell(CELL, SEED, 0.3, trace, "cpu", manifest=manifest,
                            workdir=str(tmp_path), spec=spec)


def _fails(found, limits) -> bool:
    return any(v > float(limits[k]) for k, (v, _) in found.items())


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    from portbench.gen_v1725 import daw_run, write_daw_files

    _, spec = tiny()
    fmt = spec.config["format"]
    arrays = daw_run(fmt, RECORDS, SEED, "cpu")
    paths = write_daw_files(str(tmp_path_factory.mktemp("daw")), "r", arrays,
                            int(fmt["channels"]), int(fmt["files"]))
    return arrays, paths


def test_generator_draws_the_deployment(written):
    arrays, _ = written
    _, spec = tiny()
    fmt = spec.config["format"]
    length, channel = arrays["length"], arrays["channel"]
    s1 = (np.arange(RECORDS) // 16) % 2 == 0
    assert np.array_equal(channel, np.tile(np.arange(16), RECORDS // 16))
    assert np.all(length % 2 == 0)
    assert length[s1].min() >= 128 and length[s1].max() <= 192
    assert length[~s1].min() >= 256 and length[~s1].max() <= 1024
    assert len(arrays["pool"]) == length.sum()
    # negative pulses below the DC level, inside 14 bits
    assert arrays["baseline"] == fmt["dc_level"] == 14000
    assert arrays["pool"].max() < 14100 and 13000 < arrays["pool"].min() < 13800
    assert np.array_equal(arrays["sample_index"] % 2500, (channel % 4) * 5)


@pytest.mark.parametrize("engine", ["native", "python"])
def test_writer_reads_back_through_the_ports_reader(written, engine):
    from waveformanalysis_tpu_torch.formats.v1725 import V1725Reader
    from waveformanalysis_tpu_torch.native import decode_v1725_bytes

    arrays, paths = written
    if engine == "native":
        parts = [decode_v1725_bytes(Path(p).read_bytes()) for p in paths]
        if parts[0] is None:
            pytest.skip("the native decoder did not build here")
        got = {k: np.concatenate([p[k] for p in parts]) for k in
               ("channel", "timestamp", "baseline", "trunc", "event_length")}
        pool = np.concatenate([p["wave_pool"] for p in parts])
    else:
        data = V1725Reader().read_files(paths)
        got = {"channel": data["channel"], "timestamp": data["timestamp"],
               "baseline": data["baseline"], "trunc": data["trunc"],
               "event_length": np.array([len(w) for w in data["wave"]])}
        pool = np.concatenate(list(data["wave"]))
    assert np.array_equal(got["channel"], arrays["channel"])
    assert np.array_equal(got["event_length"], arrays["length"])
    assert np.array_equal(got["timestamp"], arrays["sample_index"])
    assert np.all(got["baseline"] == arrays["baseline"]) and not np.any(got["trunc"])
    assert np.array_equal(pool.view(np.int16), arrays["pool"])


@pytest.fixture(scope="module")
def window(tmp_path_factory):
    _, spec = tiny()
    kind = harness.load_named("kinds", spec.workload["kind"])
    ref = harness.load_named("reference", spec.workload["kind"])
    from portbench.trace import Recorder

    d = kind.Driver(spec.config, spec.workload, SEED, torch.device("cpu"),
                    tmp_path_factory.mktemp("v1725"))
    try:
        d.setup()
        with Recorder(trace=False, cuda=False) as rec:
            d.window(0.1, rec)
        inputs = d.inputs()
        expected = ref.reference(inputs, spec.config, spec.workload, "cpu")
        return spec, ref, inputs, expected, d.answers(random.Random(SEED))
    finally:
        d.close()


def test_program_agrees_and_the_control_is_not_correct(window):
    spec, ref, inputs, expected, answers = window
    assert not _fails(ref.compare(expected, answers), spec.workload["limits"])
    control = ref.control(inputs, spec.config, spec.workload, "cpu")
    assert _fails(ref.compare(expected, control), spec.workload["limits"])


def _flip_polarity(bundle):
    """One record's polarity flipped, where the records are made."""
    pol = np.asarray(bundle.records["polarity"]).copy()
    pol[len(pol) // 3] *= -1
    return bundle.records.with_columns(polarity=pol)


def _length_off_by_two(bundle):
    """One S2 record's length 2 short (its last word left out)."""
    length = np.asarray(bundle.records["event_length"]).copy()
    length[int(np.argmax(length))] -= 2
    return bundle.records.with_columns(event_length=length)


@pytest.mark.parametrize("fault", [_flip_polarity, _length_off_by_two],
                         ids=["polarity_flipped", "length_off_by_2"])
def test_fault_in_the_records_is_not_correct(fault, tmp_path, monkeypatch):
    from waveformanalysis_tpu_torch.plugins.builtin import records as R
    from waveformanalysis_tpu_torch.processing.records_builder import RecordsBundle

    real = R.get_records_bundle

    def planted(*a, **k):
        b = real(*a, **k)
        return RecordsBundle(records=fault(b), wave_pool=b.wave_pool)

    monkeypatch.setattr(R, "get_records_bundle", planted)
    res = run(tmp_path)
    assert not res["correct"]
    assert res["checks"]["exact_cells"]["value"] > 0 or res["checks"]["f32_gap"]["value"] > 1e-4


def test_traced_run_reads_the_new_metrics(tmp_path):
    res = run(tmp_path, trace=True)
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert {"pool_filter_batches.run", "records_pad_fill.run", "decode_mb_per_s.records",
            "records_pad_ms.run", "pool_filter_ms.run"} <= set(m)
    from portbench.gen_v1725 import daw_run

    arrays = daw_run(tiny()[1].config["format"], RECORDS, SEED, "cpu")
    pairs = len(set(zip(arrays["channel"].tolist(), arrays["length"].tolist())))
    assert m["pool_filter_batches.run"] == pairs
    width = 128 * -(-int(arrays["length"].max()) // 128)
    assert m["records_pad_fill.run"] == pytest.approx(
        100.0 * arrays["length"].sum() / (RECORDS * width))
    assert m["decode_mb_per_s.records"] > 0


def test_reference_and_generator_import_nothing_of_the_program():
    for f in (ROOT / "portbench" / "reference" / "v1725_runs.py",
              ROOT / "portbench" / "gen_v1725.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("waveformanalysis_tpu_torch",
                                               "waveformanalysis_tpu", "jax"), (f, n)
