"""One run of one cell: set-up, the measured window, the check, one line.

``main`` is ``portbench/run.py``'s entry. ``run_cell`` does the work and
takes the device as an argument, so that the tests drive a whole run on the
CPU at a tiny size; ``main`` is what refuses to run without the cards the
cell asks for. Everything a cell needs is found by name (see the package's
docstring): this file holds nothing of any one cell.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "waveformanalysis_tpu")


def process_age_s() -> float:
    """Seconds since this process started (/proc/self/stat's start time on
    the boot clock); the time since this module was imported elsewhere."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def written_bytes() -> Optional[int]:
    """Bytes this process has caused to be written to storage."""
    try:
        with open("/proc/self/io") as fh:
            for line in fh:
                if line.startswith("write_bytes:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


def host_counters() -> Dict[str, float]:
    """This process's CPU seconds (all threads), page faults and context
    switches, and the machine's CPU seconds by state (/proc/stat: ``steal``
    is time the host gave this machine's CPUs to others)."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"process_cpu_s": ru.ru_utime + ru.ru_stime, "minflt": ru.ru_minflt,
           "nvcsw": ru.ru_nvcsw, "nivcsw": ru.ru_nivcsw}
    try:
        with open("/proc/stat") as fh:
            fields = fh.readline().split()[1:9]
        tick = os.sysconf("SC_CLK_TCK")
        for key, v in zip(("user", "nice", "system", "idle", "iowait", "irq", "softirq",
                           "steal"), fields):
            out[f"machine_{key}_s"] = int(v) / tick
    except (OSError, ValueError):
        pass
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def card_info() -> Dict[str, str]:
    """The card's name, clocks, power draw and power limit (nvidia-smi)."""
    fields = ("name", "clocks.sm", "clocks.max.sm", "clocks.mem", "power.draw",
              "power.limit", "temperature.gpu")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(fields)}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    first = out.strip().splitlines()[0] if out.strip() else ""
    return dict(zip(fields, (v.strip() for v in first.split(","))))


def load_json(path: Path) -> Any:
    with open(path) as fh:
        return json.load(fh)


def by_name(name: str) -> List[str]:
    """``name`` and the names it falls back to, its last dot-part cut each
    time: a metric ``a.b.c`` is read as ``a.b.c``, else ``a.b``, else ``a``
    (``chain_roofline.64k`` is the quantity ``chain_roofline`` of the cells
    that report it)."""
    parts = name.split(".")
    return [".".join(parts[:i]) for i in range(len(parts), 0, -1)]


def load_named(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module, or the first file of the
    names ``name`` falls back to (a metric's name may hold dots, so it is
    loaded from its file)."""
    path = next((p for p in (BENCH / kind / f"{n}.py" for n in by_name(name)) if p.is_file()),
                None)
    if path is None:
        raise FileNotFoundError(f"no {kind} module {kind}/{name}.py or its fallbacks")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}._{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(manifest: dict, name: str) -> SimpleNamespace:
    """A cell's manifest entry, its configuration, and its parameters: the
    traffic mix's (``traffic/<mix>.json``, whose ``kind`` names the driver
    and the reference) with the cell's own (``workloads/<cell>.json``)."""
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(entries)}")
    entry = entries[name]
    config_entry = {c["name"]: c for c in manifest["configs"]}[entry["config"]]
    params = dict(load_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
                  **load_json(BENCH / "workloads" / f"{name}.json"))
    return SimpleNamespace(entry=entry, workload=params,
                           config=load_json(ROOT / config_entry["file"]))


def metrics_of(manifest: dict, name: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (``trace`` 0) or per-layer metrics."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def limit_of(workload: dict, check: str) -> float:
    return float(workload["limits"][check])


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             manifest: Optional[dict] = None, workdir: Optional[str] = None,
             spec: Optional[SimpleNamespace] = None) -> dict:
    """Run cell ``name`` once on ``device`` and return its result line as
    a dict (and what was compared, under ``checks``). ``spec`` replaces the
    cell's files (the tests shrink a cell with it)."""
    import torch

    manifest = manifest if manifest is not None else load_json(ROOT / "BENCHMARK.json")
    spec = spec or cell(manifest, name)
    cuda = torch.device(device).type == "cuda"
    kind = load_named("kinds", spec.workload["kind"])
    reference = load_named("reference", spec.workload["kind"])
    from portbench.trace import Recorder

    tmp = Path(tempfile.mkdtemp(prefix="portbench-", dir=workdir))
    driver = kind.Driver(spec.config, spec.workload, seed, torch.device(device), tmp)
    try:
        driver.setup()
        setup_s = process_age_s()
        io0, host0 = written_bytes(), host_counters()
        rec = Recorder(trace=trace, cuda=cuda)
        with rec:
            out = driver.window(seconds, rec)
        io1, host1 = written_bytes(), host_counters()
        host = {k: round(host1[k] - host0[k], 3) for k in host1 if k in host0}
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        t_check = time.perf_counter()
        answers = driver.answers(random.Random(seed))
        expected = reference.reference(driver.inputs(), spec.config, spec.workload, device)
        found = reference.compare(expected, answers)
        check_s = time.perf_counter() - t_check
    finally:
        driver.close()
        shutil.rmtree(tmp, ignore_errors=True)
    checks = {k: {"value": v, "limit": limit_of(spec.workload, k), "where": where}
              for k, (v, where) in found.items()}
    correct = out["failed"] == 0 and all(c["value"] <= c["limit"] for c in checks.values())

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": int(spec.entry.get("chips", 1)), "memory_peak_bytes": int(peak)}
    written = None if io0 is None or io1 is None else io1 - io0
    summary = rec.device_summary()
    if trace:
        device_info["busy_s"] = summary["busy_s"] if summary else 0.0
        device_info["window_s"] = rec.window_s
    run = SimpleNamespace(rec=rec, device=summary, window_s=rec.window_s, counts=out["counts"],
                          written_bytes=written, workload=spec.workload, config=spec.config)
    metrics = {}
    if trace:
        for m in metrics_of(manifest, name, trace=True):
            value = load_named("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["end_to_end"], setup_s=setup_s)
        for m in metrics_of(manifest, name, trace=False):
            value = next((values[n] for n in by_name(m["name"]) if n in values), None)
            if value is not None:  # none where no request finished: correct is false
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info}
    if trace and summary:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    result["_notes"] = {"setup_s": setup_s, "window_s": rec.window_s, "walls": out["walls"],
                        "written_bytes_window": written, "counts": out["counts"],
                        "check_s": check_s, "host_window": host,
                        "setup_phases": getattr(driver, "setup_phases", {})}
    return result


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    import torch

    manifest = load_json(ROOT / "BENCHMARK.json")
    chips = int(cell(manifest, args.workload).entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"portbench: the cell needs {chips} CUDA device(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count={torch.cuda.device_count()}: no run, no fallback to the CPU")
        return 2
    log(f"portbench: card {card_info()}")
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                      manifest=manifest, workdir=os.environ.get("TMPDIR"))
    notes = result.pop("_notes")
    log(f"portbench: card after the window {card_info()}")
    log(f"portbench: set-up {notes['setup_s']:.3f} s, window {notes['window_s']:.3f} s, "
        f"check {notes['check_s']:.3f} s, counts {notes['counts']}, walls s {notes['walls']}, "
        f"set-up phases s {notes['setup_phases']}")
    log(f"portbench: host counters over the window {notes['host_window']}")
    import resource

    log(f"portbench: peak host memory (ru_maxrss) "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024} bytes")
    log(f"portbench: bytes written (write_bytes of /proc/self/io): in the window "
        f"{notes['written_bytes_window']}, by the whole process {written_bytes()}; files the "
        f"run wrote: {notes['counts'].get('files_bytes', 0)} bytes")
    found = forbidden_modules()
    if found:
        log(f"portbench: modules of JAX or the JAX package are loaded: {found}")
        return 3
    for k, c in result["checks"].items():
        log(f"check {k}: {c['value']!r} limit {c['limit']!r} (worst at {c['where']})")
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in result["checks"].items()}
    print(json.dumps(result), flush=True)
    return 0
