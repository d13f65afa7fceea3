"""Multi-device scaling: the fused chain sharded over a device mesh.

    python -m waveformanalysis_tpu_torch.examples.multichip_demo [--device cpu]

Shards the event axis over a ("data",) mesh of ``N_SHARDS`` devices
(``parallel.spread_devices``: the cards in blocks, so one card holds every
shard; ``--device cpu`` repeats the CPU). Per-event outputs stay sharded on
their devices while run statistics (S1/S2 counts, total area) are summed
over the mesh. The plain sharded chain runs first, as in the JAX package's
examples/multichip_demo.py, then the chain kernel K1 on every shard
(``make_sharded_chain_scan``; its plain version on the CPU), whose labels
must equal the plain chain's.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import numpy as np

import waveformanalysis_tpu_torch as wa
from waveformanalysis_tpu_torch.parallel.mesh import make_mesh, spread_devices

N_SHARDS = 8


def main(device: str = "cuda") -> Dict[str, Any]:
    """Run the demo; returns the statistics it printed."""
    mesh = make_mesh(devices=spread_devices(device, N_SHARDS))
    print(f"device: {mesh.device_type}")
    print(f"mesh: {N_SHARDS} shards on {len(set(mesh.devices.flat))} device(s)")

    # amplitude-mode peak finding with thresholds matched to the synthetic
    # pulses so the demo shows both S1 (narrow) and S2 (wide) populations
    cfg = wa.ChainConfig(use_derivative=False, peak_height=80.0,
                         peak_prominence=50.0, peak_width=2.0)
    batch = wa.example_chain_batch(n_events=N_SHARDS * 64, wave_length=256,
                                   device=mesh.devices.flat[0])
    out = wa.make_sharded_chain(mesh, cfg)(*batch)

    # per-event outputs are sharded across the mesh
    print(f"label sharding: {out['label'].sharding}")
    # statistics were summed over the mesh axis
    stats = {"n_s1": int(out["n_s1"]), "n_s2": int(out["n_s2"]),
             "total_area": float(out["total_area"])}
    print(f"S1={stats['n_s1']}  S2={stats['n_s2']}  "
          f"total_area={stats['total_area']:.1f}")

    labels = np.asarray(out["label"])
    assert stats["n_s1"] == int(np.sum(labels == 1))
    assert stats["n_s2"] == int(np.sum(labels == 2))
    print("sharded statistics match the gathered per-event labels")

    k1 = wa.make_sharded_chain_scan(mesh, cfg)(*batch)
    assert np.array_equal(np.asarray(k1["label"]), labels)
    assert (int(k1["n_s1"]), int(k1["n_s2"])) == (stats["n_s1"], stats["n_s2"])
    print("make_sharded_chain_scan labels = the plain sharded chain's")
    return stats


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()
    main(device=args.device)
