"""Context time domain: epochs, time indexes, and time-range access.

Behavioral analog of the reference time domain
(reference: waveform_analysis/core/context_time.py:65-520): per-run time
indexes, channel-filtered queries, manual/automatic epoch management, and
absolute-datetime queries. Two time domains coexist
(reference: context.py:229-231): ``system_ns`` uses the ``time`` field,
``raw_ps`` the ADC ``timestamp`` field; ``config["time_domain"]`` selects.
"""

from __future__ import annotations

import logging
from datetime import datetime
from typing import Any, Dict, Optional, Tuple


from waveformanalysis_tpu_torch.foundation.time_conversion import (
    EpochExtractor,
    EpochInfo,
    TimeConverter,
)

logger = logging.getLogger(__name__)

TIME_DOMAIN_FIELDS = {"system_ns": "time", "raw_ps": "timestamp"}


class TimeDomain:
    """Epoch + time-index management for a Context."""

    def __init__(self, context: Any) -> None:
        self.ctx = context
        self._epochs: Dict[str, EpochInfo] = {}
        self._engine = None

    @property
    def engine(self):
        if self._engine is None:
            from waveformanalysis_tpu_torch.data.query import TimeRangeQueryEngine

            self._engine = TimeRangeQueryEngine(self.ctx)
        return self._engine

    def time_field(self) -> str:
        domain = self.ctx.config.get("time_domain", "raw_ps")
        if domain not in TIME_DOMAIN_FIELDS:
            raise ValueError(
                f"Unknown time_domain {domain!r}; use 'system_ns' or 'raw_ps'"
            )
        return TIME_DOMAIN_FIELDS[domain]

    # -- epochs -------------------------------------------------------------------

    def set_epoch(self, run_id: str, epoch: Any, source: str = "manual") -> EpochInfo:
        """Set the run epoch from an EpochInfo, datetime, or unix seconds."""
        if isinstance(epoch, EpochInfo):
            info = epoch
        elif isinstance(epoch, datetime):
            info = EpochInfo.from_datetime(epoch, source=source)
        elif isinstance(epoch, (int, float)):
            info = EpochInfo.from_timestamp(float(epoch), source=source)
        else:
            raise TypeError(f"Unsupported epoch type: {type(epoch)}")
        self._epochs[run_id] = info
        return info

    def get_epoch(self, run_id: str) -> Optional[EpochInfo]:
        return self._epochs.get(run_id)

    def auto_extract_epoch(self, run_id: str) -> Optional[EpochInfo]:
        """Best-effort epoch from the run's raw file names/headers/ctimes."""
        if run_id in self._epochs:
            return self._epochs[run_id]
        try:
            raw_files = self.ctx.get_data(run_id, "raw_files")
        except Exception:
            raw_files = []
        files = [f for group in (raw_files or []) for f in group]
        if not files:
            return None
        info = EpochExtractor().auto_extract(files)
        if info is not None:
            self._epochs[run_id] = info
        return info

    def get_time_converter(self, run_id: str) -> Optional[TimeConverter]:
        info = self._epochs.get(run_id) or self.auto_extract_epoch(run_id)
        return TimeConverter(info) if info else None

    # -- indexes / queries -----------------------------------------------------------

    def build_time_index(self, run_id: str, data_name: str,
                         channel: Optional[int] = None, force: bool = False):
        return self.engine.build_index(
            run_id, data_name, channel=channel,
            time_field=self.time_field(), force=force,
        )

    def time_range(
        self,
        run_id: str,
        data_name: str,
        start: Optional[int] = None,
        end: Optional[int] = None,
        channel: Optional[int] = None,
    ) -> Any:
        """Rows intersecting [start, end) in the active time domain."""
        return self.engine.query_time_range(
            run_id, data_name, start=start, end=end, channel=channel,
            time_field=self.time_field(),
        )

    def query_multi_channel_time_range(
        self,
        run_id: str,
        data_name: str,
        start: Optional[int] = None,
        end: Optional[int] = None,
        channels: Optional[Tuple[int, ...]] = None,
    ) -> Dict[int, Any]:
        return self.engine.query_multi_channel_time_range(
            run_id, data_name, start=start, end=end, channels=channels,
            time_field=self.time_field(),
        )

    def time_range_absolute(
        self,
        run_id: str,
        data_name: str,
        start_dt: Optional[datetime] = None,
        end_dt: Optional[datetime] = None,
    ) -> Any:
        converter = self.get_time_converter(run_id)
        if converter is None:
            raise ValueError(
                f"No epoch for run {run_id}; call set_epoch() or provide "
                "raw files with date-bearing names"
            )
        return self.engine.query_absolute(
            run_id, data_name, start_dt=start_dt, end_dt=end_dt,
            converter=converter, time_field=self.time_field(),
        )
