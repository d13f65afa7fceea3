"""Frozen copy of the port's plain Savitzky-Golay filter (``ops/filtering.py``
of waveformanalysis_tpu_torch at the commit that added this benchmark),
mode 'interp'. Imports nothing of the program."""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


@lru_cache(maxsize=64)
def _savgol_matrices(window: int, polyorder: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fir_coeffs, left_edge_matrix, right_edge_matrix) for mode='interp'.

    Edge matrices map the first/last ``window`` samples to the halfwin fitted
    edge values (pure linear algebra — exact parity with scipy's polyfit
    edge handling).
    """
    halflen = window // 2
    pos = np.arange(-halflen, window - halflen, dtype=np.float64)
    # FIR coefficients: projection of delta onto poly basis evaluated at 0
    V = np.vander(pos, polyorder + 1, increasing=True)  # (window, p+1)
    pinv = np.linalg.pinv(V)  # (p+1, window)
    fir = pinv[0]  # evaluate fitted poly at x=0
    # edge fit: t = 0..window-1 sample positions
    t = np.arange(window, dtype=np.float64)
    Vt = np.vander(t, polyorder + 1, increasing=True)
    pinv_t = np.linalg.pinv(Vt)  # (p+1, window)
    # left edge: evaluate at t = 0..halflen-1 ; right edge at the mirror
    eval_left = np.vander(t[:halflen], polyorder + 1, increasing=True)
    E_left = eval_left @ pinv_t  # (halflen, window)
    eval_right = np.vander(t[window - halflen :], polyorder + 1, increasing=True)
    E_right = eval_right @ pinv_t
    return fir[::-1].copy(), E_left, E_right


def savgol(x: torch.Tensor, window: int, polyorder: int) -> torch.Tensor:
    """Savitzky-Golay smoothing (mode='interp') of an (n, L) tensor, float32
    out, on the tensor's device; the window clamps to L and down to odd, and
    a window <= polyorder passes the waves through."""
    x = x.to(torch.float32)
    L = x.shape[1]
    window = min(int(window), L)
    if window % 2 == 0:
        window -= 1
    if window <= polyorder:
        return x.clone()
    fir, E_left, E_right = _savgol_matrices(window, int(polyorder))
    m = L - window + 1  # interior outputs: positions halflen .. L-halflen-1
    taps = fir.astype(np.float32).tolist()
    interior = taps[0] * x[:, :m]
    for k in range(1, window):
        interior = interior + taps[k] * x[:, k:k + m]

    def edge(samples: torch.Tensor, E: np.ndarray) -> torch.Tensor:
        E32 = torch.from_numpy(E.astype(np.float32)).to(x.device)
        return (samples[:, None, :] * E32[None]).sum(dim=-1)

    left = edge(x[:, :window], E_left)
    right = edge(x[:, L - window:], E_right)
    return torch.cat([left, interior, right], dim=1)
