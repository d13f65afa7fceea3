#!/usr/bin/env python3
"""Time the port's find_peaks (K2) and width-crossing (K4) kernels in turns
with an earlier build of the same two kernels, on one NVIDIA GPU.

    python3 scripts/scan_kernel_turns.py --parent DIR

DIR holds ``peaks_scan.cu``, ``width_scan.cu`` and ``scan_common.cuh`` of
an earlier version of ``waveformanalysis_tpu_torch/csrc`` whose kernels take
the time-major ``(L, n)`` input (one thread per event): the entries
``wfa_peaks_scan(x_t, vlen, out, params, stream)`` and
``wfa_width_scan(w_t, is_float, baseline, positions, out, params,
stream)`` with the parameter and output structs this checkout still uses.
Their wrapper step is the transposing copy, the output allocation and the
launch, as that version's wrappers did.

On bench.py's waves (``make_batch(65536, 256, seed=0)``, repeated to
1,048,576 events), at K = 32 with the route's settings, the script prints
per size, as medians of CUDA-event timings over fresh inputs:

- the kernels alone on cold copies (more bytes than the 50 MB L2 holds):
  the earlier kernel on time-major copies, this checkout's on event-major
  ones;
- the wrapper steps on the same cold copies: the earlier transposing copy,
  allocation and launch against this checkout's ``find_peaks_scan`` /
  ``width_crossings_scan``;

all in turns (earlier, new, new, earlier), in one process on one card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import bound, check, median_ms, nbytes  # noqa: E402

K, L, N_BASE = 32, 256, 65_536
PEAKS_KW = dict(height=80.0, prominence=50.0, width=2.0, distance=2, max_peaks=K)
FRACS = (0.1, 0.9, 0.9, 0.1)


def build_earlier(parent: Path, name: str) -> ctypes.CDLL:
    """nvcc ``parent/<name>.cu`` with the port's flags into build/."""
    from waveformanalysis_tpu_torch.kernels._build import BUILD_DIR, NVCC_FLAGS, find_nvcc

    src = parent / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + (parent / "scan_common.cuh").read_bytes())
    so = BUILD_DIR / f"earlier_{name}_{key.hexdigest()[:16]}.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(so), str(src)],
                          capture_output=True, text=True)
    check(proc.returncode == 0, f"nvcc {src}: {proc.stderr[-2000:]}")
    return ctypes.CDLL(str(so))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="directory with the earlier peaks_scan.cu / width_scan.cu")
    args = ap.parse_args()
    check(torch.cuda.is_available(), "needs a CUDA GPU")
    from bench import make_batch
    from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc
    from waveformanalysis_tpu_torch.ops import width_scan_cuda as wsc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"scan kernel turns on {smi}", flush=True)
    dev = torch.device("cuda:0")
    stream = torch.cuda.current_stream(dev).cuda_stream
    old2 = build_earlier(args.parent, "peaks_scan")
    old2.wfa_peaks_scan.argtypes = [ctypes.c_void_p] * 5
    old4 = build_earlier(args.parent, "width_scan")
    old4.wfa_width_scan.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
    new2, new4 = csc._peaks_library(), wsc._library()
    w_base = torch.from_numpy(make_batch(N_BASE, L, seed=0)).to(dev)

    for size in (N_BASE, 1_048_576):
        w = w_base.repeat(size // N_BASE, 1)
        sig = w.float() - 1000.0
        el = torch.full((size,), L, dtype=torch.int32, device=dev)
        n_copies = 4 if size == N_BASE else 2
        sig_e = [sig + k for k in range(n_copies)]
        sig_t = [s.t().contiguous() for s in sig_e]
        outs2 = csc._tables(csc._PEAKS_OUTS, size, K, dev)
        ptrs2 = csc._PeaksOut(*(outs2[name].data_ptr() for name, _ in csc._PEAKS_OUTS))
        prm2 = csc._PeaksParams(n=size, L=L, K=K, distance=2, height=80.0, prominence=50.0,
                                width=2.0, rel_height=0.5)

        def old_k2(k):
            err = old2.wfa_peaks_scan(sig_t[k % n_copies].data_ptr(), el.data_ptr(),
                                      ctypes.byref(ptrs2), ctypes.byref(prm2), stream)
            check(err == 0, f"earlier peaks kernel: cudaError {err}")

        lay2 = csc.row_layout(L, 4, sig_e[0].data_ptr(), csc.PEAK_SLOT_BYTES)

        def new_k2(k):
            err = new2.wfa_peaks_scan(sig_e[k % n_copies].data_ptr(), el.data_ptr(),
                                      ctypes.byref(ptrs2), ctypes.byref(prm2), lay2.rows,
                                      int(lay2.staged), int(lay2.vec), stream)
            check(err == 0, f"peaks kernel: cudaError {err}")

        def old_step2(k):
            x_t = sig_e[k % n_copies].t().contiguous()
            o = csc._tables(csc._PEAKS_OUTS, size, K, dev)
            p = csc._PeaksOut(*(o[name].data_ptr() for name, _ in csc._PEAKS_OUTS))
            check(old2.wfa_peaks_scan(x_t.data_ptr(), el.data_ptr(), ctypes.byref(p),
                                      ctypes.byref(prm2), stream) == 0, "earlier peaks step")

        def new_step2(k):
            csc.find_peaks_scan(sig_e[k % n_copies], valid_length=el, **PEAKS_KW)

        t_old, t_new = median_ms(old_k2), median_ms(new_k2)
        t_new2, t_old2 = median_ms(new_k2), median_ms(old_k2)
        s_old, s_new = median_ms(old_step2), median_ms(new_step2)
        s_new2, s_old2 = median_ms(new_step2), median_ms(old_step2)
        b2 = bound(nbytes(sig, el, *outs2.values()), 8.0 * size * L)[0]
        print(f"K2 {size}x{L} K={K}: alone, earlier {t_old:.3f} / {t_old2:.3f} ms, new "
              f"{t_new:.3f} / {t_new2:.3f} ms; steps, earlier (copy + kernel) {s_old:.3f} / "
              f"{s_old2:.3f} ms, new {s_new:.3f} / {s_new2:.3f} ms; bound {b2:.4f} ms",
              flush=True)
        pos = outs2["position"].clone()
        del outs2, sig_t, sig_e

        blw = w.float()[:, :50].sum(dim=1) / 50
        w_e = [w + k for k in range(n_copies)]
        w_t = [x.t().contiguous() for x in w_e]
        outs4 = {key: torch.empty((size, K), dtype=torch.int32 if key.endswith("_idx")
                                  else torch.float32, device=dev) for key in wsc.OUT_KEYS}
        ptrs4 = wsc._WidthOut(*(outs4[key].data_ptr() for key in wsc.OUT_KEYS))
        prm4 = wsc._WidthParams(n=size, L=L, K=K, interpolation=1, rise_low=0.1,
                                rise_high=0.9, fall_high=0.9, fall_low=0.1)

        def old_k4(k):
            err = old4.wfa_width_scan(w_t[k % n_copies].data_ptr(), 0, blw.data_ptr(),
                                      pos.data_ptr(), ctypes.byref(ptrs4), ctypes.byref(prm4),
                                      stream)
            check(err == 0, f"earlier width kernel: cudaError {err}")

        lay4 = csc.row_layout(L, 2, w_e[0].data_ptr())

        def new_k4(k):
            err = new4.wfa_width_scan(w_e[k % n_copies].data_ptr(), 0, blw.data_ptr(),
                                      pos.data_ptr(), ctypes.byref(ptrs4), ctypes.byref(prm4),
                                      lay4.rows, int(lay4.staged), int(lay4.vec), stream)
            check(err == 0, f"width kernel: cudaError {err}")

        def old_step4(k):
            x_t = w_e[k % n_copies].t().contiguous()
            o = {key: torch.empty((size, K), dtype=torch.int32 if key.endswith("_idx")
                                  else torch.float32, device=dev) for key in wsc.OUT_KEYS}
            p = wsc._WidthOut(*(o[key].data_ptr() for key in wsc.OUT_KEYS))
            check(old4.wfa_width_scan(x_t.data_ptr(), 0, blw.data_ptr(), pos.data_ptr(),
                                      ctypes.byref(p), ctypes.byref(prm4), stream) == 0,
                  "earlier width step")

        def new_step4(k):
            wsc.width_crossings_scan(w_e[k % n_copies], blw, pos, *FRACS)

        t_old, t_new = median_ms(old_k4), median_ms(new_k4)
        t_new2, t_old2 = median_ms(new_k4), median_ms(old_k4)
        s_old, s_new = median_ms(old_step4), median_ms(new_step4)
        s_new2, s_old2 = median_ms(new_step4), median_ms(old_step4)
        b4 = bound(nbytes(w, blw, pos, *outs4.values()), 2.0 * size * L)[0]
        print(f"K4 {size}x{L} K={K} int16: alone, earlier {t_old:.3f} / {t_old2:.3f} ms, new "
              f"{t_new:.3f} / {t_new2:.3f} ms; steps, earlier (copy + kernel) {s_old:.3f} / "
              f"{s_old2:.3f} ms, new {s_new:.3f} / {s_new2:.3f} ms; bound {b4:.4f} ms; "
              f"occupied slots {int((pos >= 0).sum())}", flush=True)
        del w, sig, w_e, w_t, outs4, pos
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
