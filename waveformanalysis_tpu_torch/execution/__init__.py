"""Host-side execution: pools, timeouts, validation, cancellation, balancing
(port of ``waveformanalysis_tpu/execution``)."""

from waveformanalysis_tpu_torch.execution.cancellation import (
    CancellationManager,
    CancellationToken,
    TaskCancelledException,
)
from waveformanalysis_tpu_torch.execution.load_balancer import (
    DynamicLoadBalancer,
    quantize_workers,
)
from waveformanalysis_tpu_torch.execution.manager import (
    EXECUTOR_CONFIGS,
    ExecutorManager,
    get_executor,
    is_picklable,
    parallel_apply,
    parallel_map,
    resolve_executor_config,
)
from waveformanalysis_tpu_torch.execution.timeout import TimeoutManager, with_timeout
from waveformanalysis_tpu_torch.execution.validation import ValidationManager

__all__ = [
    "ExecutorManager",
    "get_executor",
    "parallel_map",
    "parallel_apply",
    "EXECUTOR_CONFIGS",
    "resolve_executor_config",
    "is_picklable",
    "TimeoutManager",
    "with_timeout",
    "ValidationManager",
    "CancellationToken",
    "CancellationManager",
    "TaskCancelledException",
    "DynamicLoadBalancer",
    "quantize_workers",
]
