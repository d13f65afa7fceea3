"""Global constants shared across the framework.

Semantics mirror the reference's foundation constants
(reference: waveform_analysis/core/foundation/constants.py) so that numeric
defaults (feature windows, chunk sizes, ...) produce identical results.
TPU-specific tiling constants are new here.
"""

from __future__ import annotations


class FeatureDefaults:
    """Default parameters for waveform feature extraction."""

    # Sample-index window (start, end) used for peak/height computation.
    PEAK_RANGE = (40, 90)

    # Sample-index window for charge/area integration; end=None -> to end of wave.
    CHARGE_RANGE = (0, None)

    # Sample-index window for baseline estimation.
    BASELINE_RANGE = (0, 20)

    # Event-grouping coincidence window (ns).
    TIME_WINDOW_NS = 100

    # Minimum separation between detected peaks (samples).
    MIN_PEAK_DISTANCE = 10

    # Minimum peak height threshold.
    MIN_PEAK_HEIGHT = 0.01


class ProcessingDefaults:
    """Defaults that control chunking, buffering and parallel processing."""

    CHUNK_SIZE = 50_000
    BUFFER_SIZE = 4 * 1024 * 1024  # 4 MB IO buffer
    MEMMAP_MODE = "r"
    DEFAULT_WORKERS = 4
    CACHE_EXPIRY_SECONDS = 3600


class StorageDefaults:
    """Storage-layer defaults."""

    STORAGE_VERSION = "1.0.0"
    LOCK_TIMEOUT = 10.0
    LOCK_RETRY_INTERVAL = 0.1
    COMPRESSION_LEVEL = 3
    MAX_RETRIES = 3


class ValidationDefaults:
    """Validation tolerances."""

    TIME_MONOTONIC_TOLERANCE = 1.0  # ns
    CHUNK_BOUNDARY_TOLERANCE = 0.001  # ns
    MAX_MEMORY_USAGE = 8 * 1024 * 1024 * 1024  # bytes


class TPUDefaults:
    """TPU-specific shape/tiling policy (new in this build; no reference analog).

    Batched waveform kernels pad the event axis to a multiple of SUBLANE and the
    sample axis to a multiple of LANE so XLA/Mosaic can tile them onto the VPU/MXU
    without relayout. Length bucketing keeps recompilation bounded: event counts
    are padded up to the next bucket boundary.
    """

    LANE = 128  # last-dim tile (all dtypes)
    SUBLANE_F32 = 8  # second-to-last-dim tile for f32
    SUBLANE_BF16 = 16
    SUBLANE_I8 = 32

    # Event-axis bucket sizes: pad n_events up to the next power of two between
    # these bounds (below MIN -> MIN; above MAX -> multiple of MAX).
    MIN_EVENT_BUCKET = 128
    MAX_EVENT_BUCKET = 1 << 20

    # Max hits/peaks emitted per waveform in fixed-capacity kernels.
    MAX_HITS_PER_WAVEFORM = 32


class VisualizationDefaults:
    """Plotting defaults."""

    FIGURE_SIZE = (12, 8)
    DPI = 100
    COLORMAP = "viridis"
    LINEAGE_NODE_WIDTH = 3.0
    LINEAGE_NODE_HEIGHT = 1.5


def event_bucket(n: int) -> int:
    """Pad an event count up to the next compilation bucket boundary.

    Keeps the number of distinct jit shapes logarithmic in data size.
    """
    if n <= TPUDefaults.MIN_EVENT_BUCKET:
        return TPUDefaults.MIN_EVENT_BUCKET
    if n >= TPUDefaults.MAX_EVENT_BUCKET:
        m = TPUDefaults.MAX_EVENT_BUCKET
        return ((n + m - 1) // m) * m
    b = TPUDefaults.MIN_EVENT_BUCKET
    while b < n:
        b <<= 1
    return b


def pad_to_multiple(n: int, m: int) -> int:
    """Round ``n`` up to the next multiple of ``m``."""
    return ((n + m - 1) // m) * m
