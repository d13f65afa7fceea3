"""Wave-source selection for feature plugins.

Behavioral analog of the reference wave-source helper
(reference: waveform_analysis/core/plugins/builtin/cpu/_wave_source.py:93-229):
plugins taking waveform input accept ``wave_source`` =
auto|records|st_waveforms|filtered_waveforms, driving *dynamic* depends_on.
``auto`` resolves to filtered_waveforms when ``use_filtered`` is set, else
st_waveforms — NEVER records (reference ``resolve_depends_on``
_wave_source.py:103-112: the records source must be requested explicitly).
This matters for identity semantics: record_id/event_index in downstream
tables index into the resolved source's row order, and st_waveforms vs
records use different orderings. The round-4 differential oracle
(tests/test_reference_differential.py) caught the earlier auto->records
preference producing reference-divergent joins in s1_s2.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from waveformanalysis_tpu_torch.dtypes.table import Table

WAVE_SOURCE_AUTO = "auto"
WAVE_SOURCE_RECORDS = "records"
WAVE_SOURCE_ST = "st_waveforms"
WAVE_SOURCE_FILTERED = "filtered_waveforms"

VALID_WAVE_SOURCES = (
    WAVE_SOURCE_AUTO,
    WAVE_SOURCE_RECORDS,
    WAVE_SOURCE_ST,
    WAVE_SOURCE_FILTERED,
)


@dataclass(frozen=True)
class WaveInputSpec:
    source: str
    depends_on: tuple
    expected_name: str
    # records source only: which pool backs the waves (reference
    # _wave_source.py:103-106 — use_filtered selects wave_pool_filtered)
    wave_pool_name: str = "wave_pool"

    @property
    def is_records(self) -> bool:
        return self.source == WAVE_SOURCE_RECORDS


@dataclass
class WaveInput:
    spec: WaveInputSpec
    waveform_data: Optional[Table] = None  # flat-array sources
    records: Optional[Table] = None  # records source
    records_view: Optional[Any] = None  # records source (not ported yet)


def resolve_wave_input_spec(context: Any, plugin: Any) -> WaveInputSpec:
    """Pick the wave source from config + registered plugins."""
    source = WAVE_SOURCE_AUTO
    if "wave_source" in plugin.options:
        source = context.get_config(plugin, "wave_source") or WAVE_SOURCE_AUTO
    if source not in VALID_WAVE_SOURCES:
        raise ValueError(
            f"Plugin '{plugin.provides}': invalid wave_source {source!r}; "
            f"expected one of {VALID_WAVE_SOURCES}"
        )
    use_filtered = False
    if "use_filtered" in plugin.options:
        use_filtered = bool(context.get_config(plugin, "use_filtered"))

    registered = set(getattr(context, "plugins", {}) or {})

    if source == WAVE_SOURCE_AUTO:
        # reference semantics: auto = filtered when use_filtered else st;
        # the records source is only used when requested explicitly
        if use_filtered and WAVE_SOURCE_FILTERED in registered:
            source = WAVE_SOURCE_FILTERED
        else:
            source = WAVE_SOURCE_ST

    if source == WAVE_SOURCE_RECORDS:
        # reference semantics (_wave_source.py:103-106): the records
        # source honors use_filtered by reading the FILTERED pool
        pool = "wave_pool_filtered" if use_filtered else "wave_pool"
        return WaveInputSpec(
            source=source, depends_on=("records", pool),
            expected_name="records", wave_pool_name=pool,
        )
    return WaveInputSpec(source=source, depends_on=(source,), expected_name=source)


def load_wave_input(
    context: Any, plugin: Any, run_id: str, needs_wave_samples: bool = True
) -> WaveInput:
    """Load the selected wave input, normalizing to Table."""
    spec = resolve_wave_input_spec(context, plugin)
    if spec.is_records:
        raise NotImplementedError(
            "the records / wave_pool wave source is not ported to the "
            "PyTorch package yet (ROADMAP.md, port queue); use st_waveforms"
        )

    data = context.get_data(run_id, spec.expected_name)
    return WaveInput(spec=spec, waveform_data=_as_table(data))


def wave_matrix_view(col: Any) -> Any:
    """A wave column ready for device kernels, WITHOUT forcing a copy.

    Tensors (already on a device) pass through so the padded matrix stays
    where it is all the way into the fused kernels; host columns normalize
    to np.ndarray.
    """
    import torch

    if isinstance(col, torch.Tensor):
        return col
    return np.asarray(col)


def _as_table(data: Any) -> Optional[Table]:
    if data is None or isinstance(data, Table):
        return data
    if isinstance(data, np.ndarray) and data.dtype.names is not None:
        return Table.from_numpy(data)
    raise TypeError(
        f"Expected Table or structured array for wave input, got {type(data)}"
    )
