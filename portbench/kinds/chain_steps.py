"""Closed-loop steps of the standalone fused chain, ``make_chain_scan``.

One client calls the chain step on a batch of ``events`` waveforms of the
configuration's length, waits until its outputs are ready on the device
(``torch.cuda.synchronize``) and calls it on the next batch. The batches
cycle over a pool of ``pool`` distinct batches made on the device from the
seed with bench.py's arithmetic (``portbench.gen.make_batch``), so that no
step reads its inputs from the L2 cache. Set-up builds the pool and runs
the step once on every batch of it (the kernel's build or load, the first
launch). Two steps of the window, drawn from the seed, are kept for the
check.
"""

from __future__ import annotations

import random
import time
from pathlib import Path

import torch

from portbench.gen import generator, make_batch


def pool(config: dict, params: dict, seed: int, device, size: int) -> list:
    """The first ``size`` batches of the pool of this seed: (waves,
    event_length, baselines, polarity codes) on ``device``."""
    gen = generator(seed, device)
    n, L = int(params["events"]), int(config["wave_length"])
    return [(make_batch(n, L, gen),
             torch.full((n,), L, dtype=torch.int32, device=device),
             torch.full((n,), float(config["baseline"]), device=device),
             torch.full((n,), int(config["polarity"]), dtype=torch.int8, device=device))
            for _ in range(size)]


def control_inputs(config: dict, params: dict, seed: int, device) -> dict:
    """Inputs of the check for batches a run of this seed makes, without the
    run: the first ``compared_steps`` batches of the pool."""
    size = min(int(params["compared_steps"]), int(params["pool"]))
    return {"batches": dict(enumerate(pool(config, params, seed, device, size))),
            "chain": config["chain"]}


class Driver:
    def __init__(self, config: dict, workload: dict, seed: int, device: torch.device,
                 workdir: Path) -> None:
        self.config, self.workload, self.seed, self.dev = config, workload, seed, device
        self.n = int(workload["events"])
        self.L = int(config["wave_length"])
        self.samples: list = []

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def setup(self) -> None:
        from waveformanalysis_tpu_torch.models.full_chain import ChainConfig
        from waveformanalysis_tpu_torch.ops.chain_scan_cuda import make_chain_scan

        self.step = make_chain_scan(ChainConfig(**self.config["chain"]))
        self.pool = pool(self.config, self.workload, self.seed, self.dev,
                         int(self.workload["pool"]))
        for batch in self.pool:
            self.step(*batch)
        self.sync()

    def window(self, seconds: float, rec) -> dict:
        keep = int(self.workload["compared_steps"])
        rng = random.Random(self.seed)
        walls = []
        steps = 0
        t0 = time.perf_counter()
        while True:
            b = steps % len(self.pool)
            s0 = time.perf_counter()
            with rec.span("portbench.step"):
                out = self.step(*self.pool[b])
                self.sync()
            walls.append(time.perf_counter() - s0)
            # reservoir sampling: every step is kept with the same chance
            if steps < keep:
                self.samples.append((b, out))
            else:
                j = rng.randint(0, steps)
                if j < keep:
                    self.samples[j] = (b, out)
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        self.steps = steps
        return {"end_to_end": {"chain_waveforms_per_s": steps * self.n / window_s},
                "attempted": steps, "failed": 0,
                "counts": {"steps": steps, "events": self.n, "wave_length": self.L,
                           "pool": len(self.pool)},
                "walls": [round(sum(walls), 6), round(max(walls), 6)]}

    def answers(self, rng: random.Random) -> list:
        """The kept steps' outputs, on the host."""
        return [(b, {k: v.cpu() for k, v in out.items()}) for b, out in self.samples]

    def inputs(self) -> dict:
        used = sorted({b for b, _ in self.samples})
        return {"batches": {b: self.pool[b] for b in used}, "chain": self.config["chain"]}

    def close(self) -> None:
        self.samples = []
        self.pool = []
