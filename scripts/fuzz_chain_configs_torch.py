#!/usr/bin/env python
"""Differential fuzz of the port's fused chain across random configs
(polarity mixes, variable lengths, every capacity and gating path).

The twin of scripts/fuzz_chain_configs.py: the same generator, its random
calls in the same order, so a seed gives that tool's configs and waves.

    python scripts/fuzz_chain_configs_torch.py [--trials 14] [--seed 99]
    python scripts/fuzz_chain_configs_torch.py --device cpu [--trials 14] [--seed 99]

On the card (the default) each trial holds the chain kernel K1
(``make_chain_scan``) and the tile chain K7 (``make_chain_tile``) against
the port's plain ``full_chain_step``. With ``--device cpu`` it holds the
port's plain ``full_chain_step`` against the JAX package's XLA
``full_chain_step``; where a trial differs, the JAX package's Pallas chain
kernel (``chain_scan_pallas``, interpret mode) settles it:

- ``reference split``: the port equals the Pallas kernel, which itself
  differs from the XLA chain (the JAX package disagrees with itself);
- ``PORT MISMATCH``: the port differs from both.

Integer outputs must match exactly, float32 ones within atol 1e-3 / rtol
1e-4. Every trial that is not OK prints its config and each differing row
with the values. Exit 1 on a ``PORT MISMATCH`` (on the card: a kernel that
differs from the plain chain), else 0. Only the CPU reference imports JAX,
inside the functions that ``--device cpu`` runs.

``--lengths`` draws the wave lengths from another list (the configs and
waves then differ from the JAX twin's), e.g. ``--lengths 192,250,256,257,
300`` for rows on both sides of K1's register path (L <= 256).

The reproducer's interface: ``--only N`` runs trial N alone (the earlier
ones are still drawn, so it sees the same configs and waves) and ``--rows
A:B`` cuts each trial's events to that slice, because whether the JAX
package's XLA chain splits from its Pallas kernel depends on the batch's
shape. ``--device cpu --trials 21 --seed 7 --only 20 --rows 240:248``
reproduces the split that ROADMAP Queue 3 records.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

ATOL, RTOL = 1e-3, 1e-4
N_EVENTS = 256
LENGTHS = (64, 96, 128, 192)  # the JAX twin's wave lengths
OK, SPLIT, MISMATCH = "OK", "reference split", "PORT MISMATCH"


def draw_trial(rng: np.random.Generator, lengths=LENGTHS) -> tuple:
    """One trial of the generator: (L, (waves, event_length, baselines,
    polarity_codes), ChainConfig fields), L drawn from ``lengths``."""
    L = int(rng.choice(list(lengths)))
    n = N_EVENTS
    t = np.arange(L)
    waves = np.full((n, L), 1000.0)
    for i in range(n):
        for c in rng.integers(4, L - 4, size=rng.integers(0, 4)):
            s = rng.uniform(1.5, 20)
            waves[i] += (rng.choice([-1, 1]) * rng.uniform(30, 400)
                         * np.exp(-((t - c) ** 2) / (2 * s * s)))
    waves += rng.normal(0, rng.uniform(0.5, 4), waves.shape)
    waves = np.round(np.clip(waves, -32768, 32767)).astype(np.int16)
    el = np.full(n, L, np.int32)
    el[rng.integers(0, n, 10)] = rng.integers(8, L, 10)
    pol = (rng.random(n) < 0.5).astype(np.int8)
    bl = np.full(n, 1000.0, np.float32)
    fields = dict(
        use_derivative=bool(rng.integers(2)),
        peak_height=float(rng.choice([5, 30, 80])),
        peak_distance=int(rng.choice([1, 2, 5])),
        peak_prominence=float(rng.choice([0.7, 10, 50])),
        peak_width=float(rng.choice([0, 2, 4])),
        max_peaks=int(rng.choice([4, 8])),
        hit_threshold=float(rng.choice([5, 10, 40])),
        left_extension=int(rng.choice([0, 2])),
        right_extension=int(rng.choice([0, 2])),
        max_hits=int(rng.choice([4, 8])),
        height_range=(int(rng.integers(0, 8)), int(rng.integers(32, 64))),
    )
    return L, (waves, el, bl, pol), fields


def trials(n_trials: int, seed: int, only: int | None = None, rows: slice | None = None,
           lengths=LENGTHS):
    """Yield (trial, L, arrays, fields) for each trial of ``seed``; with
    ``only``, that trial alone, and with ``rows``, its events cut to them."""
    rng = np.random.default_rng(seed)
    for trial in range(n_trials):
        L, arrays, fields = draw_trial(rng, lengths)
        if only is not None and trial != only:
            continue
        if rows is not None:
            arrays = tuple(a[rows] for a in arrays)
        yield trial, L, arrays, fields


def differing(ref: dict, got: dict) -> dict:
    """{key: mask of the rows where ``got`` differs from ``ref``} for every
    key that differs: integer outputs exactly, float32 beyond atol / rtol."""
    if list(got) != list(ref):
        raise AssertionError(f"keys {list(got)} != {list(ref)}")
    bad = {}
    for k, a in ref.items():
        b = got[k]
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{k}: {b.dtype}{b.shape} != {a.dtype}{a.shape}")
        if np.issubdtype(a.dtype, np.floating):
            mask = ~np.isclose(b, a, atol=ATOL, rtol=RTOL)
        else:
            mask = a != b
        if mask.any():
            bad[k] = mask
    return bad


def worst_f32(ref: dict, got: dict) -> float:
    """The largest |difference| of the float32 outputs."""
    return max((float(np.max(np.abs(got[k].astype(np.float64) - a)))
                for k, a in ref.items() if np.issubdtype(a.dtype, np.floating) and a.size),
               default=0.0)


def row_lines(bad: dict, named: dict, first: int = 0) -> list:
    """One line per differing row and key, with each named output's value;
    rows numbered from ``first`` (the first event of a cut)."""
    lines = []
    for k, mask in bad.items():
        for r in (np.flatnonzero(mask) if mask.ndim else [None]):
            vals = ", ".join(f"{name} {out[k] if r is None else out[k][r]}"
                             for name, out in named.items())
            lines.append(f"    row {'-' if r is None else first + int(r)} {k}: {vals}")
    return lines


def port_plain(arrays: tuple, fields: dict, device) -> dict:
    """The port's plain ``full_chain_step`` on ``device``, as NumPy."""
    from waveformanalysis_tpu_torch.device import to_numpy
    from waveformanalysis_tpu_torch.models.full_chain import (
        ChainConfig,
        batch_from_numpy,
        full_chain_step,
    )

    batch = batch_from_numpy(*arrays, device=device)
    out = full_chain_step(*batch, ChainConfig.from_fields(fields))
    return {k: to_numpy(v) for k, v in out.items()}


def jax_chains(arrays: tuple, fields: dict, pallas: bool = False) -> dict:
    """The JAX package's XLA ``full_chain_step``, or with ``pallas`` its
    Pallas chain kernel in interpret mode, on the CPU, as NumPy. The CPU
    reference: the one place the port's tools import JAX."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from waveformanalysis_tpu.models.full_chain import ChainConfig, full_chain_step
    from waveformanalysis_tpu.ops.chain_scan_pallas import chain_scan_pallas

    cfg = ChainConfig(**fields)
    args = tuple(jnp.asarray(a) for a in arrays)
    out = (chain_scan_pallas(*args, cfg, interpret=True) if pallas
           else full_chain_step(*args, cfg))
    return {k: np.asarray(v) for k, v in out.items()}


def cpu_trial(arrays: tuple, fields: dict, first: int = 0) -> dict:
    """The port's plain chain against JAX's XLA chain, JAX's Pallas kernel
    settling a difference. Returns {"status", "bad": {key: rows}, "lines",
    "worst", "outputs"}."""
    port = port_plain(arrays, fields, "cpu")
    xla = jax_chains(arrays, fields)
    bad = differing(xla, port)
    outputs = {"port": port, "xla": xla}
    status = OK
    if bad:
        outputs["pallas"] = jax_chains(arrays, fields, pallas=True)
        status = SPLIT if not differing(outputs["pallas"], port) else MISMATCH
    return {"status": status, "bad": bad, "lines": row_lines(bad, outputs, first),
            "worst": worst_f32(xla, port), "outputs": outputs}


def card_trial(arrays: tuple, fields: dict, device, first: int = 0) -> dict:
    """K1 and K7 against the port's plain ``full_chain_step`` on ``device``
    (on CPU tensors the wrappers run their plain versions). Returns
    {"status", "bad": {kernel: {key: rows}}, "lines", "worst", "outputs"}."""
    from waveformanalysis_tpu_torch.device import to_numpy
    from waveformanalysis_tpu_torch.models.full_chain import ChainConfig, batch_from_numpy
    from waveformanalysis_tpu_torch.ops.chain_scan_cuda import make_chain_scan
    from waveformanalysis_tpu_torch.ops.chain_tile_cuda import make_chain_tile

    plain = port_plain(arrays, fields, device)
    batch = batch_from_numpy(*arrays, device=device)
    cfg = ChainConfig.from_fields(fields)
    outputs, bad, lines, worst = {"plain": plain}, {}, [], 0.0
    for name, make in (("K1", make_chain_scan), ("K7", make_chain_tile)):
        outputs[name] = {k: to_numpy(v) for k, v in make(cfg)(*batch).items()}
        worst = max(worst, worst_f32(plain, outputs[name]))
        diff = differing(plain, outputs[name])
        if diff:
            bad[name] = diff
            lines += row_lines(diff, {"plain": plain, name: outputs[name]}, first)
    return {"status": MISMATCH if bad else OK, "bad": bad, "lines": lines,
            "worst": worst, "outputs": outputs}


def run(n_trials: int, seed: int, device, only: int | None = None,
        rows: slice | None = None, lengths=LENGTHS) -> list:
    """Every trial's result, printed as it goes: K1 and K7 against the plain
    chain on a device other than the CPU, the port against the JAX package
    on the CPU."""
    import torch

    from waveformanalysis_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    first = rows.indices(N_EVENTS)[0] if rows is not None else 0
    results = []
    for trial, L, arrays, fields in trials(n_trials, seed, only, rows, lengths):
        t0 = time.perf_counter()
        res = cpu_trial(arrays, fields, first) if dev == torch.device("cpu") \
            else card_trial(arrays, fields, dev, first)
        res.update(trial=trial, L=L, fields=fields, seconds=time.perf_counter() - t0)
        head = (f"trial {trial:2d} L={L:3d} deriv={fields['use_derivative']} "
                f"K={fields['max_peaks']} Kh={fields['max_hits']}: {res['status']}")
        if res["status"] == OK:
            print(head)
        else:
            print(f"{head} {sorted(res['bad'])} {fields!r}")
            for line in res["lines"]:
                print(line)
        results.append(res)
    return results


def parse_rows(text: str) -> slice:
    start, _, stop = text.partition(":")
    return slice(int(start) if start else None, int(stop) if stop else None)


def main(argv=None, results: list | None = None) -> int:
    """Run the fuzz; ``results``, when given a list, receives each trial's
    result (status, differing rows, worst f32 error, the outputs)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=14)
    ap.add_argument("--seed", type=int, default=99)
    ap.add_argument("--device", default="cuda",
                    help="cuda (K1 and K7 against the plain chain) or cpu (the "
                         "port against the JAX package)")
    ap.add_argument("--only", type=int, default=None, help="run this trial alone")
    ap.add_argument("--rows", type=parse_rows, default=None,
                    help="cut each trial's events to START:STOP")
    ap.add_argument("--lengths", type=lambda t: tuple(int(v) for v in t.split(",")),
                    default=LENGTHS,
                    help="comma-separated wave lengths a trial draws from (default the "
                         "JAX twin's 64,96,128,192; K1 takes rows longer than 256 on "
                         "its staged path)")
    args = ap.parse_args(argv)
    if results is None:
        results = []
    results.extend(run(args.trials, args.seed, args.device, args.only, args.rows,
                       args.lengths))
    counts = {s: sum(r["status"] == s for r in results) for s in (OK, SPLIT, MISMATCH)}
    worst = max((r["worst"] for r in results), default=0.0)
    print(f"trials: {len(results)}; ok {counts[OK]}, reference splits {counts[SPLIT]}, "
          f"port mismatches {counts[MISMATCH]}; worst |f32 diff| {worst:.3g}")
    return 1 if counts[MISMATCH] else 0


if __name__ == "__main__":
    raise SystemExit(main())
