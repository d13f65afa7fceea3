"""Fused-chain demo: the chain's three implementations end to end.

    python -m waveformanalysis_tpu_torch.examples.fused_chain_demo [--device cuda] [--events 65536]

Runs one mixed S1/S2 batch (``example_chain_batch(n, 256)``: even events
carry a narrow S1 pulse, odd events a wide S2) through the plain PyTorch
chain (``make_chain``), the tile kernel (``make_chain_tile``, K7) and the
streaming-scan kernel (``make_chain_scan``, K1), all through the package
facade. It prints each one's time, accuracy and S1/S2 counts, and whether
the two kernel entries equal the plain chain on label, n_peaks,
peak_position and n_hits. On the CPU the kernel entries run their plain
version (the kernels need a GPU). The port's counterpart of the JAX
package's examples/fused_chain_demo.py.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict

import numpy as np
import torch

import waveformanalysis_tpu_torch as wa

AGREE_KEYS = ("label", "n_peaks", "peak_position", "n_hits")


def _timed(step, batch, device: torch.device):
    t0 = time.perf_counter()
    out = step(*batch)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def main(device: str = "cuda", n_events: int = 65536) -> Dict[str, Any]:
    """Run the demo; returns each implementation's numbers and whether the
    kernel entries agree with the plain chain."""
    cfg = wa.ChainConfig(use_derivative=False, peak_height=80.0,
                         peak_prominence=50.0, peak_width=2.0)
    batch = wa.example_chain_batch(n_events=n_events, wave_length=256, device=device)
    dev = batch[0].device
    truth = np.where(np.arange(n_events) % 2 == 0, 1, 2)  # odd index = wide S2

    steps = {
        "plain": wa.make_chain(cfg),
        "tile-cuda": wa.make_chain_tile(cfg),
        "scan-cuda": wa.make_chain_scan(cfg),
    }
    outs, results = {}, {}
    for name, step in steps.items():
        _, first = _timed(step, batch, dev)  # on a GPU: builds the kernel
        out, warm = _timed(step, batch, dev)
        labels = out["label"].cpu().numpy()
        results[name] = {
            "first_s": first, "warm_s": warm,
            "accuracy": float(np.mean(labels == truth)),
            "n_s1": int((labels == 1).sum()), "n_s2": int((labels == 2).sum()),
        }
        outs[name] = out
        r = results[name]
        print(f"{name:10s} first call {first:8.3f} s, warm {warm * 1e3:9.3f} ms  "
              f"accuracy={r['accuracy']:.3f}  S1={r['n_s1']} S2={r['n_s2']}", flush=True)

    agree = {name: all(torch.equal(outs["plain"][k], outs[name][k]) for k in AGREE_KEYS)
             for name in ("tile-cuda", "scan-cuda")}
    for name, same in agree.items():
        print(f"{name:10s} {', '.join(AGREE_KEYS)} identical to the plain chain: {same}",
              flush=True)
    return {"device": str(dev), "n_events": n_events, "results": results, "agree": agree}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--events", type=int, default=65536, help="events in the batch")
    args = parser.parse_args()
    result = main(device=args.device, n_events=args.events)
    sys.exit(0 if all(result["agree"].values()) else 1)
