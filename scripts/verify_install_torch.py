#!/usr/bin/env python
"""Install check of the port: imports, facade, torch device, a first-use
kernel build, tiny pipeline.

The twin of scripts/verify_install.py. Run it after installing (or from a
checkout) to confirm the port is usable end to end on this machine:

1. the package imports and every lazy ``__all__`` name of the facade
   resolves;
2. torch executes a reduction on the device;
3. the chain kernel K1 builds with nvcc at first use (or loads an earlier
   build) and a tiny ``make_chain_scan`` step equals the plain
   ``full_chain_step`` (ints exact, f32 within atol 1e-3 / rtol 1e-4);
4. a tiny injected-waveform pipeline produces basic_features through a
   real Context on the device, storage round trip and a bit-identical
   cache hit included.

    python scripts/verify_install_torch.py               # on the card
    python scripts/verify_install_torch.py --device cpu  # step 3 not run

Under ``--device cpu`` the kernel step prints ``not run: device cpu`` and
does not count as passed. Exit 0 when no step failed, 1 with a per-step
report otherwise.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

ATOL, RTOL = 1e-3, 1e-4


class NotRun(Exception):
    """A step that does not apply to the device asked for."""


def step(name):
    def deco(fn):
        fn._step_name = name
        return fn
    return deco


@step("package import + version")
def check_import(dev):
    import waveformanalysis_tpu_torch as wa

    return f"waveformanalysis_tpu_torch {getattr(wa, '__version__', '(dev)')}"


@step("facade: every lazy __all__ name resolves")
def check_facade(dev):
    import waveformanalysis_tpu_torch as wa

    missing = []
    for name in wa.__all__:
        try:
            getattr(wa, name)
        except Exception:
            missing.append(name)
    if missing:
        raise RuntimeError(f"unresolvable facade names: {missing}")
    return f"{len(wa.__all__)} names"


@step("torch executes on the device")
def check_torch(dev):
    import torch

    total = float(torch.arange(16.0, device=dev).sum())
    if total != 120.0:
        raise RuntimeError(f"sum returned {total}, expected 120.0")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return f"{dev}: {name}, torch {torch.__version__}"


@step("first-use kernel build + tiny K1 step = full_chain_step")
def check_kernel(dev):
    import numpy as np
    import torch

    if dev.type != "cuda":
        raise NotRun(f"device {dev.type}")
    from waveformanalysis_tpu_torch.kernels._build import build
    from waveformanalysis_tpu_torch.models.full_chain import (
        ChainConfig,
        example_chain_batch,
        full_chain_step,
    )
    from waveformanalysis_tpu_torch.ops.chain_scan_cuda import chain_scan_cuda, make_chain_scan

    built = build("chain_scan")
    cfg = ChainConfig(use_derivative=False, peak_height=80.0, peak_prominence=50.0,
                      peak_width=2.0)
    batch = example_chain_batch(64, 128, seed=0, device=dev)
    before = chain_scan_cuda.launches
    out = make_chain_scan(cfg)(*batch)
    torch.cuda.synchronize()
    if chain_scan_cuda.launches != before + 1:
        raise RuntimeError("the chain kernel was not launched")
    ref = full_chain_step(*batch, cfg)
    for k, r in ref.items():
        a, b = r.cpu().numpy(), out[k].cpu().numpy()
        same = (np.isclose(b, a, atol=ATOL, rtol=RTOL) if np.issubdtype(a.dtype, np.floating)
                else a == b)
        if a.dtype != b.dtype or a.shape != b.shape or not np.all(same):
            raise RuntimeError(f"K1 output {k} differs from full_chain_step")
    how = f"built in {built.seconds:.1f} s" if built.seconds else "earlier build loaded"
    return f"{built.path.name} ({how}); 64 x 128 events equal"


@step("tiny pipeline: st_waveforms -> basic_features (+cache hit)")
def check_pipeline(dev):
    import numpy as np

    from waveformanalysis_tpu_torch.device import to_host
    from waveformanalysis_tpu_torch.plugins.builtin.basic_features import BasicFeaturesPlugin
    from waveformanalysis_tpu_torch.testing.fixtures import make_tiny_context

    with tempfile.TemporaryDirectory(prefix="wfa_verify_") as tmp:
        with make_tiny_context(tmp, config={"device": str(dev)}, n_events=8,
                               wave_length=64) as ctx:
            ctx.register(BasicFeaturesPlugin())
            arr = to_host(ctx.get_data("test_run", "basic_features")).to_numpy()
        if len(arr) != 8:
            raise RuntimeError(f"expected 8 feature rows, got {len(arr)}")
        if not np.all(np.isfinite(arr["area"])):
            raise RuntimeError("non-finite areas in basic_features")
        # a second Context over the same storage loads the table from disk
        with make_tiny_context(tmp, config={"device": str(dev)}, n_events=8,
                               wave_length=64) as ctx:
            ctx.register(BasicFeaturesPlugin())
            if not ctx.storage.exists(ctx.key_for("test_run", "basic_features"), "test_run"):
                raise RuntimeError("basic_features was not saved to the storage")
            again = to_host(ctx.get_data("test_run", "basic_features")).to_numpy()
        for f in arr.dtype.names:
            if not np.array_equal(arr[f], again[f]):
                raise RuntimeError(f"cache round-trip changed field {f}")
    return "8 events, cache round-trip bit-identical"


CHECKS = [check_import, check_facade, check_torch, check_kernel, check_pipeline]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to check (default cuda, which raises without a card)")
    args = ap.parse_args(argv)
    from waveformanalysis_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    failed, passed, not_run = [], 0, 0
    for fn in CHECKS:
        name = fn._step_name
        try:
            detail = fn(dev)
            passed += 1
            print(f"  ok: {name}" + (f" — {detail}" if detail else ""))
        except NotRun as why:
            not_run += 1
            print(f"  not run: {why}: {name}")
        except Exception:
            failed.append(name)
            print(f"FAIL: {name}")
            traceback.print_exc()
    print(f"install check: {'FAILED' if failed else 'OK'} ({passed} of {len(CHECKS)} "
          f"steps passed, {not_run} not run, {len(failed)} failed)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
