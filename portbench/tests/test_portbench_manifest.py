"""BENCHMARK.json against the rules of its format, and every name it uses
against the files the harness finds by that name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TEXT_KEYS = ("why", "layer", "source")


def test_manifest_keys():
    assert list(MANIFEST) == ["command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} <= {"name", "unit", "better", "bound", "source", "layer",
                                          "moves"}


def test_command_and_paths():
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and cmd[1] == "portbench/run.py"
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    for word in cmd:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word


def test_names_units_and_texts():
    groups = {"configs": MANIFEST["configs"], "workloads": MANIFEST["workloads"],
              "metrics": MANIFEST["end_to_end"] + MANIFEST["per_layer"]}
    for group, entries in groups.items():
        names = [e["name"] for e in entries]
        assert len(names) == len(set(names)), group
        for e in entries:
            assert NAME.match(e["name"]), e["name"]
            for k in TEXT_KEYS:
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in MANIFEST["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for m in groups["metrics"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_metrics_sources_and_bounds():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert "bound" not in m
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_layers_are_one_line_and_consistent():
    layers = {}
    for m in MANIFEST["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_cell_reports_what_it_must():
    cells = [w["name"] for w in MANIFEST["workloads"]]

    def reported(group, cell):
        return [m for m in MANIFEST[group] if cell in m.get("workloads", cells)]

    for cell in cells:
        e2e = [m["name"] for m in reported("end_to_end", cell)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        per_layer = reported("per_layer", cell)
        assert per_layer, cell
        for m in per_layer:  # the metric it moves is one the cell reports
            assert m["moves"] in e2e, (cell, m["name"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert set(m.get("workloads", cells)) <= set(cells)


def test_chips_and_pairs():
    ws = MANIFEST["workloads"]
    assert 1 <= len(ws) <= 24
    assert all(w["chips"] in (1, 4) for w in ws)
    assert sum(w["chips"] == 4 for w in ws) <= max(1, len(ws) // 4)
    pairs = [(w["config"], w["traffic"]) for w in ws]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in ws}
    assert used == {c["name"] for c in MANIFEST["configs"]}


@pytest.mark.parametrize("w", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell_files_exist(w):
    """Every name a cell uses has its file: the cell's settings, the traffic
    mix (data only), the mix kind's driver and reference, the configuration."""
    assert (BENCH / "workloads" / f"{w['name']}.json").is_file()
    mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    assert (BENCH / "kinds" / f"{mix['kind']}.py").is_file()
    assert (BENCH / "reference" / f"{mix['kind']}.py").is_file()
    assert not list((BENCH / "traffic").glob("*.py"))
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    cfile = ROOT / configs[w["config"]]["file"]
    assert cfile.is_file() and cfile.is_relative_to(BENCH)
    workload = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
    assert set(workload["limits"]) == {"structure", "exact_cells", "f32_gap"}
    assert workload["limits"]["structure"] == 0 and workload["limits"]["exact_cells"] == 0


@pytest.mark.parametrize("m", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_metric_readers_exist(m):
    from portbench.harness import load_named

    assert callable(load_named("metrics", m["name"]).read)


def test_config_files_are_distinct_and_name_their_source():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert c["source"].startswith("https://")
