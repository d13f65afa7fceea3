"""Whole runs of each traffic kind on the CPU at a tiny size, past the
harness's look for a card: the program's answers agree with the plain
reference; the control (the reference in bfloat16 in the program's place)
and each fault the cells can have (an answer altered where it is produced,
half of the batch left out) come out as not correct. The card's runs of the
same comparisons are the benchmark's own."""

import json
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 977  # more than 32 signed bits hold


def tiny(name: str):
    """The cell's files with a tiny size: 1,024 events a run or a batch."""
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    spec = harness.cell(manifest, name)
    if spec.workload["kind"] == "file_runs":
        spec.config["events"] = 1024
    else:
        spec.workload.update(events=512, pool=3)
    return manifest, spec


def run(name: str, tmp_path, trace=False, seconds=0.5):
    manifest, spec = tiny(name)
    return harness.run_cell(name, SEED, seconds, trace, "cpu", manifest=manifest,
                            workdir=str(tmp_path), spec=spec)


CELLS = [w["name"] for w in harness.load_json(ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_program_agrees_with_the_reference(name, tmp_path):
    res = run(name, tmp_path)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    e2e = set(res["metrics"])
    assert "setup_s" in e2e and len(e2e) >= 2
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert [k for k in res if not k.startswith("_")][:5] == [
        "correct", "attempted", "failed", "metrics", "device"]
    assert [k for k in res if not k.startswith("_")][-1] == "checks"


@pytest.mark.parametrize("name", ["vx2730_default.tables", "chain_bench.scan_64k"])
def test_traced_run_reads_the_program_spans(name, tmp_path):
    res = run(name, tmp_path, trace=True)
    assert res["correct"]
    # no device trace on the CPU: the device metrics stay out of the line
    assert not any(k.startswith(("device_", "chain_")) for k in res["metrics"])
    if name.startswith("vx2730"):
        assert {"ingest_ms.run", "members_ms.run", "event_tables_ms",
                "cache_writer_ms.run", "files_waveforms_per_s"} <= set(res["metrics"])


def test_member_spans_do_not_nest(tmp_path):
    """members_ms.run and event_tables_ms add up spans that never lie inside
    one another on a thread."""
    manifest, spec = tiny("vx2730_default.tables")
    kind = harness.load_named("kinds", "file_runs")
    from portbench.trace import Recorder

    members = harness.load_named("metrics", "members_ms.run").KEYS
    tables = harness.load_named("metrics", "event_tables_ms").KEYS
    d = kind.Driver(spec.config, spec.workload, SEED, torch.device("cpu"), tmp_path)
    try:
        d.setup()
        with Recorder(trace=False, cuda=False) as rec:
            d.window(0.3, rec)
    finally:
        d.close()
    assert rec.nested(members | tables) == []
    assert rec.union_s(members) > 0


def _inputs_and_expected(name, tmp_path):
    manifest, spec = tiny(name)
    kind = harness.load_named("kinds", spec.workload["kind"])
    ref = harness.load_named("reference", spec.workload["kind"])
    from portbench.trace import Recorder

    d = kind.Driver(spec.config, spec.workload, SEED, torch.device("cpu"), tmp_path)
    try:
        d.setup()
        with Recorder(trace=False, cuda=False) as rec:
            d.window(0.2, rec)
        answers = d.answers(random.Random(SEED))
        inputs = d.inputs()
    finally:
        d.close()
    expected = ref.reference(inputs, spec.config, spec.workload, "cpu")
    return spec, ref, inputs, expected, answers


def _fails(found, limits) -> bool:
    return any(v > float(limits[k]) for k, (v, _) in found.items())


@pytest.mark.parametrize("name", ["vx2730_default.tables", "chain_bench.scan_1m"])
def test_control_is_not_correct(name, tmp_path):
    spec, ref, inputs, expected, answers = _inputs_and_expected(name, tmp_path)
    assert not _fails(ref.compare(expected, answers), spec.workload["limits"])
    control = ref.control(inputs, spec.config, spec.workload, "cpu")
    assert _fails(ref.compare(expected, control), spec.workload["limits"])


def _tables(answer: dict) -> list:
    """The tables of one kept answer: a chain step's outputs are one table
    of tensors, a run's answer maps table names to tables."""
    if all(isinstance(v, torch.Tensor) for v in answer.values()):
        return [answer]
    return list(answer.values())


def _alter_one(answers):
    """An answer altered where it is produced: one integer of the first
    table of the first kept answer moves by one."""
    for t in _tables(answers[0][1]):
        if hasattr(t, "iloc"):
            for c in t.columns:
                if t[c].dtype.kind == "i" and len(t):
                    t.loc[t.index[0], c] += 1
                    return
            continue
        for c, v in t.items():
            arr = v.numpy().copy() if isinstance(v, torch.Tensor) else v.copy()
            if arr.dtype.kind == "i" and arr.size:
                arr.reshape(-1)[0] += 1
                t[c] = torch.from_numpy(arr) if isinstance(v, torch.Tensor) else arr
                return
    raise AssertionError("no integer answer to alter")


def _drop_half(answers):
    """Half of the batch left out: every per-row answer keeps its first half."""
    for _, answer in answers:
        if all(isinstance(v, torch.Tensor) for v in answer.values()):
            answer.update({c: v[: len(v) // 2] for c, v in answer.items() if v.ndim})
            continue
        for key, t in list(answer.items()):
            if hasattr(t, "iloc"):
                answer[key] = t.iloc[: len(t) // 2]
            else:
                answer[key] = {c: v[: len(v) // 2] for c, v in t.items()}


@pytest.mark.parametrize("fault", [_alter_one, _drop_half], ids=["altered", "half_left_out"])
@pytest.mark.parametrize("name", ["vx2730_default.tables", "chain_bench.scan_64k"])
def test_faults_are_not_correct(name, fault, tmp_path):
    spec, ref, inputs, expected, answers = _inputs_and_expected(name, tmp_path)
    fault(answers)
    assert _fails(ref.compare(expected, answers), spec.workload["limits"])


def _flip_labels(out):
    """S1 for S2 and S2 for S1 on every other row, where the labels are made."""
    lab = np.asarray(out["label"]).copy()
    lab[::2] = np.where(lab[::2] == 1, 2, 1)
    if isinstance(out, dict):
        out["label"] = torch.from_numpy(lab)
    else:
        out.columns["label"] = lab
    return out


def _half_rows(out):
    """Only the first half of the rows comes back."""
    if isinstance(out, dict):
        return {k: v[: len(v) // 2] if v.ndim else v for k, v in out.items()}
    return out[: len(out) // 2]


@pytest.mark.parametrize("fault", [_flip_labels, _half_rows], ids=["altered", "half_left_out"])
@pytest.mark.parametrize("name", ["vx2730_default.tables", "chain_bench.scan_64k"])
def test_fault_under_the_timed_path_is_not_correct(name, fault, tmp_path, monkeypatch):
    """A fault planted in the program where the answers are made (the S1/S2
    classifier of the Context, the chain step's entry) makes a whole run
    incorrect."""
    if name.startswith("vx2730"):
        from waveformanalysis_tpu_torch.plugins.builtin import s1_s2_classifier as S

        real = S.S1S2ClassifierPlugin.classify
        monkeypatch.setattr(S.S1S2ClassifierPlugin, "classify", staticmethod(
            lambda cfg, widths, features: fault(real(cfg, widths, features))))
    else:
        from waveformanalysis_tpu_torch.ops import chain_scan_cuda as C

        real = C.chain_scan_cuda
        monkeypatch.setattr(C, "chain_scan_cuda", lambda *a, **k: fault(real(*a, **k)))
    res = run(name, tmp_path)
    assert not res["correct"]
    assert res["checks"]["exact_cells"]["value"] > 0 or res["checks"]["structure"]["value"] > 0


def test_generators_repeat_from_a_seed(tmp_path):
    from portbench.gen import generator, make_batch, vx2730_run

    a = make_batch(64, 256, generator(SEED, "cpu"))
    b = make_batch(64, 256, generator(SEED, "cpu"))
    c = make_batch(64, 256, generator(SEED + 1, "cpu"))
    assert a.dtype == torch.int16 and torch.equal(a, b) and not torch.equal(a, c)
    assert 900 < float(a.float().mean()) < 1100
    w = a.numpy()
    vx2730_run(str(tmp_path / "one"), "r", w, 2, 10_000_000, 20_000)
    vx2730_run(str(tmp_path / "two"), "r", w, 2, 10_000_000, 20_000)
    for f in sorted((tmp_path / "one" / "r" / "RAW").iterdir()):
        assert f.read_bytes() == (tmp_path / "two" / "r" / "RAW" / f.name).read_bytes()


def test_vx2730_writer_is_the_ports_byte_for_byte(tmp_path):
    from portbench.gen import generator, make_batch, write_vx2730_run
    from waveformanalysis_tpu_torch.testing.fixtures import write_vx2730_run as ports

    w = make_batch(40, 128, generator(3, "cpu")).numpy()
    ts = np.arange(40, dtype=np.int64) * 10_000_000
    mine = write_vx2730_run(str(tmp_path / "a"), "r", w, ts, 1, n_files=2)
    theirs = ports(str(tmp_path / "b"), "r", w, ts, 1, n_files=2)
    assert [Path(p).read_bytes() for p in mine] == [Path(p).read_bytes() for p in theirs]


def test_roofline_contract_counts():
    from portbench import roofline

    assert roofline.chain_bytes(1, 256) == 512 + 9 + 45 + 8
    assert roofline.chain_bytes(1_048_576, 256) == 1_048_576 * 566 + 8
    assert roofline.chain_ops(10, 256) == 10 * 256 * 5
    t, by = roofline.least_seconds(roofline.chain_bytes(65_536, 256),
                                   roofline.chain_ops(65_536, 256))
    assert by == "bytes" and abs(t - (65_536 * 566 + 8) / 3.35e12) < 1e-15


def test_idle_share_and_union():
    from portbench.trace import Recorder, idle_share, union

    assert union([(5, 7), (0, 2), (1, 3), (6, 9)]) == [(0, 3), (5, 9)]
    assert idle_share(0.25, 1.0) == 0.75
    rec = Recorder(trace=False, cuda=False)
    rec.t0, rec.t1 = 0, 100
    rec.main = 1
    rec.spans = [("outer", 0, 100, 1), ("inner", 10, 40, 1), ("other", 50, 90, 2)]
    rec.device_events = [("k", 0, 10), ("k", 40, 50), ("m", 45, 60)]
    s = rec.device_summary()
    assert s["busy_s"] == 30e-9 and s["device_ops"][0] == ["k", 20e-9]
    assert s["idle_gaps"][0] == ["outer | other", 40e-9]
    assert s["idle_gaps"][1] == ["inner", 30e-9]
    assert rec.nested({"outer", "inner", "other"}) == [("outer", "inner")]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "waveformanalysis_tpu_torch.fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert not {"waveformanalysis_tpu_torch.fake", "jaxtyping_fake"} & set(
        harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "waveformanalysis_tpu.fake", object())
    assert "waveformanalysis_tpu.fake" in harness.forbidden_modules()


def test_a_run_loads_no_jax():
    """What a run imports (the harness, every driver, reference and reader,
    and the port's modules they reach) holds no module of JAX or the JAX
    package, in a fresh process."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import harness\n"
        "m = harness.load_json(harness.ROOT / 'BENCHMARK.json')\n"
        "kinds = {harness.cell(m, w['name']).workload['kind'] for w in m['workloads']}\n"
        "for k in kinds:\n"
        "    harness.load_named('kinds', k); harness.load_named('reference', k)\n"
        "for x in m['per_layer']: harness.load_named('metrics', x['name'])\n"
        "import waveformanalysis_tpu_torch.context.context, "
        "waveformanalysis_tpu_torch.plugins.plugin_sets, "
        "waveformanalysis_tpu_torch.ops.chain_scan_cuda\n"
        "from waveformanalysis_tpu_torch.plugins.plugin_sets import get_profile\n"
        "get_profile('default')\n"
        "print(harness.forbidden_modules())\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    import ast

    for f in sorted((ROOT / "portbench" / "reference").rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("waveformanalysis_tpu_torch",
                                               "waveformanalysis_tpu", "jax"), (f, n)


def test_main_refuses_without_the_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = harness.main(["--workload", "chain_bench.scan_64k", "--seed", "1",
                       "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures on the card only")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_a_short_run_on_the_card(card, tmp_path):
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                          "chain_bench.scan_64k", "--seed", str(SEED), "--seconds", "2",
                          "--trace", "1"], capture_output=True, text=True, timeout=900,
                         cwd=ROOT, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert 0 < res["metrics"]["chain_roofline.64k"]["value"] <= 100
