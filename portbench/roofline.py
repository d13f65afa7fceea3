"""Peaks of the card and the operations and bytes of an entry's contract.

The peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W power
limit (the ``device`` field of a result gives the card's own limit beside
them). A roofline share counts the work of the entry's contract, its inputs
read once and its returned outputs written once at their dtypes and shapes,
so it reads the same whatever kernels implement the entry.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# make_chain_scan's contract (ChainConfig's step over (n, L) int16 waves):
# the inputs, and the 12 per-event outputs and 2 scalar overflow counters
# it returns
CHAIN_INPUT_BYTES_PER_EVENT = 4 + 4 + 1  # event_length i4, baselines f4, polarity i1
CHAIN_OUTPUT_BYTES_PER_EVENT = 11 * 4 + 1  # 11 four-byte outputs and the i1 label
CHAIN_SCALAR_BYTES = 2 * 4  # n_peak_overflow, n_hit_overflow (i4)
# float32 operations every sample needs whatever the data: the signal's
# subtract and sign multiply, the hit threshold compare and the two
# neighbour compares of a peak candidate; the walks that depend on the data
# are not counted, so this is a lower bound
CHAIN_OPS_PER_SAMPLE = 5


def chain_bytes(n: int, L: int) -> int:
    return n * (2 * L + CHAIN_INPUT_BYTES_PER_EVENT + CHAIN_OUTPUT_BYTES_PER_EVENT) \
        + CHAIN_SCALAR_BYTES


def chain_ops(n: int, L: int) -> int:
    return n * L * CHAIN_OPS_PER_SAMPLE


def least_seconds(n_bytes: float, n_ops: float) -> tuple:
    """(seconds, bound_by): the larger of bytes over the HBM rate and float32
    operations over the f32 peak."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
