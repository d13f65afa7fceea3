"""The port's host execution layer and BatchProcessor, on the CPU.

Mirrors the JAX package's tests/test_execution.py, test_batch_processor.py
and test_batch_grid.py on the port's copies (``execution/`` and
``data/batch_processor.py``): pools, parallel helpers, timeouts,
cancellation, the load balancer, and BatchProcessor's thread, process and
``device`` executors with their error strategies, retries, cancellation,
polling, config grid and ``process_func``. Process pools start their
workers with ``spawn`` in the port. The device executor on the wave chain
is in tests/test_torch_batched.py.
"""

import sys
import threading
import time

import numpy as np
import pytest

from waveformanalysis_tpu_torch.context.context import Context
from waveformanalysis_tpu_torch.data.batch_processor import BatchProcessor
from waveformanalysis_tpu_torch.dtypes.table import Table
from waveformanalysis_tpu_torch.execution import (
    EXECUTOR_CONFIGS,
    CancellationManager,
    CancellationToken,
    DynamicLoadBalancer,
    ExecutorManager,
    TaskCancelledException,
    TimeoutManager,
    is_picklable,
    parallel_apply,
    parallel_map,
    quantize_workers,
    resolve_executor_config,
    with_timeout,
)
from waveformanalysis_tpu_torch.foundation.exceptions import TimeoutError_
from waveformanalysis_tpu_torch.kernels._build import count_launch
from waveformanalysis_tpu_torch.plugins.base import Option, Plugin


class SyntheticPlugin(Plugin):
    """Deterministic data derived from run_id; fails on demand (module
    level, so spawned workers import it)."""

    provides = "synthetic"
    version = "1.0"
    save_when = "always"
    options = {
        "scale": Option(default=1.0, type=float),
        "fail_runs": Option(default=None, type=list),
    }

    def compute(self, context, run_id, **kwargs):
        fail_runs = context.get_config(self, "fail_runs") or []
        if run_id in fail_runs:
            raise RuntimeError(f"synthetic failure for {run_id}")
        scale = context.get_config(self, "scale")
        arr = np.zeros(4, dtype=[("time", "i8"), ("v", "f8")])
        arr["time"] = np.arange(4)
        arr["v"] = sum(run_id.encode()) * scale
        return arr


class FlakyPlugin(Plugin):
    """Fails the first two attempts on run "bad"."""

    provides = "flaky"
    depends_on = []
    save_when = "never"
    attempts = {}
    lock = threading.Lock()

    def compute(self, context, run_id, **kwargs):
        with FlakyPlugin.lock:
            n = FlakyPlugin.attempts.get(run_id, 0) + 1
            FlakyPlugin.attempts[run_id] = n
        if run_id == "bad" and n < 3:
            raise RuntimeError(f"transient failure #{n}")
        return Table({"x": np.arange(2)})


@pytest.fixture
def ctx(tmp_path):
    c = Context(storage_dir=str(tmp_path / "store"),
                config={"show_progress": False, "device": "cpu"})
    c.register(SyntheticPlugin())
    return c


@pytest.fixture(autouse=True)
def _shutdown_pools():
    yield
    ExecutorManager.reset()  # stop every worker a test started


# -- execution/ ---------------------------------------------------------------

def test_executor_manager_pools():
    mgr = ExecutorManager()
    with mgr.get_executor("t", "thread", 2) as e1:
        with mgr.get_executor("t", "thread", 2) as e2:
            assert e1 is e2
    stats = mgr.get_stats()
    assert (stats["created"], stats["reused"]) == (1, 1)
    assert mgr.shutdown_idle() == 1
    with mgr.get_executor("x", "thread", 2, reuse=False):
        pass
    assert mgr.get_stats()["active_pools"] == 0
    with pytest.raises(ValueError):
        with mgr.get_executor("x", "fiber", 2):
            pass
    # process pools spawn their workers: a forked child cannot use CUDA
    pool = mgr._make("process", 1)
    assert pool._mp_context.get_start_method() == "spawn"
    pool.shutdown()


def test_named_configs_match_jax():
    from waveformanalysis_tpu.execution import manager as jmanager

    assert EXECUTOR_CONFIGS == jmanager.EXECUTOR_CONFIGS
    cfg = resolve_executor_config("io_intensive")
    assert cfg == {"executor_type": "thread", "max_workers": 16}
    with pytest.raises(KeyError):
        resolve_executor_config("nope")


def test_parallel_helpers():
    assert parallel_map(lambda x: x * 2, range(20), max_workers=4) == [
        x * 2 for x in range(20)]
    assert parallel_map(lambda x: x + 1, [1, 2, 3], max_workers=1) == [2, 3, 4]
    assert parallel_apply([lambda: 1, lambda: 2, lambda: 3], max_workers=2) == [1, 2, 3]

    def boom(x):
        if x == 3:
            raise RuntimeError("x3")
        return x

    with pytest.raises(RuntimeError, match="x3"):
        parallel_map(boom, range(6), max_workers=2)
    assert is_picklable([1, 2, 3]) and not is_picklable(lambda x: x)


def test_timeouts():
    mgr = TimeoutManager()

    def run_in_thread():
        with pytest.raises(TimeoutError_):
            mgr.run_with_timeout(lambda: time.sleep(1.0), 0.1, task_name="slow")

    t = threading.Thread(target=run_in_thread)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and mgr.stats["timed_out"] == 1
    with pytest.raises(TimeoutError_):  # SIGALRM in the main thread
        mgr.run_with_timeout(lambda: time.sleep(1.0), 0.1, task_name="s")
    assert mgr.run_with_timeout(lambda: 42, None) == 42
    with pytest.raises(KeyError):
        mgr.run_with_timeout(lambda: {}["missing"], 1.0)

    @with_timeout(5.0)
    def quick():
        return "ok"

    assert quick() == "ok"


def test_cancellation_tokens():
    token = CancellationToken("t1")
    fired = []
    token.on_cancel(lambda: fired.append(1))
    token.check()
    token.cancel()
    assert token.cancelled and fired == [1]
    with pytest.raises(TaskCancelledException):
        token.check()
    token.on_cancel(lambda: fired.append(2))  # late registration fires
    assert fired == [1, 2] and token.wait(0.01)
    mgr = CancellationManager()
    t1, t2 = mgr.create_token("a"), mgr.create_token("b")
    assert mgr.cancel_all() == 2 and t1.cancelled and t2.cancelled
    mgr.unregister(t1)
    assert mgr.active_tokens == ["b"]


def test_load_balancer():
    assert [quantize_workers(5), quantize_workers(16), quantize_workers(0),
            quantize_workers(9, max_workers=6)] == [4, 16, 1, 4]
    lb = DynamicLoadBalancer()
    w = lb.get_optimal_workers(requested=6)
    assert w & (w - 1) == 0
    lb.record_task(1.0, 100, workers=2)
    lb.record_task(1.0, 300, workers=4)
    assert lb.best_known_workers() == 4
    assert lb.suggest_batch_size(10_000, bytes_per_item=1 << 20,
                                 memory_budget_bytes=1 << 30) == 1024
    assert lb.suggest_batch_size(100, bytes_per_item=8) == 100


def test_launch_counts_survive_threads():
    """Kernel wrappers count launches from several threads (a thread pool
    of Contexts): no count is lost."""
    def wrapper():
        pass

    wrapper.launches = 0
    per_thread, n_threads = 2000, 16
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [count_launch(wrapper)
                                                    for _ in range(per_thread)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == per_thread * n_threads


# -- BatchProcessor -------------------------------------------------------------

@pytest.mark.parametrize("executor", ["thread", "process", "device"])
def test_process_runs(ctx, executor):
    bp = BatchProcessor(ctx, executor_type=executor, max_workers=2)
    result = bp.process_runs(["r1", "r2", "r3"], "synthetic")
    assert sorted(result.succeeded) == ["r1", "r2", "r3"] and not result.cancelled
    for rid in ("r1", "r2", "r3"):
        assert np.asarray(result.get(rid).data["v"])[0] == sum(rid.encode())
        # every executor's results are on disk when process_runs returns
        assert ctx.storage.exists(ctx.key_for(rid, "synthetic"), rid)


@pytest.mark.parametrize("executor", ["thread", "device"])
def test_on_error_continue(ctx, executor):
    ctx.set_config({"synthetic": {"fail_runs": ["r2"]}})
    result = BatchProcessor(ctx, executor_type=executor, on_error="continue").process_runs(
        ["r1", "r2", "r3"], "synthetic")
    assert sorted(result.succeeded) == ["r1", "r3"] and result.failed == ["r2"]
    assert "synthetic failure" in result.get("r2").error
    assert "Traceback" in result.get("r2").traceback_str


@pytest.mark.parametrize("executor", ["thread", "device"])
def test_on_error_stop(ctx, executor):
    ctx.set_config({"synthetic": {"fail_runs": ["r2"]}})
    result = BatchProcessor(ctx, executor_type=executor, on_error="stop",
                            max_workers=1).process_runs(["r1", "r2", "r3"], "synthetic")
    assert result.failed == ["r2"] and "r1" in result.succeeded
    if executor == "device":  # the serial retry stops at the failed run
        assert sorted(result.results) == ["r1", "r2"]


@pytest.mark.parametrize("executor", ["thread", "device"])
def test_on_error_raise(ctx, executor):
    ctx.set_config({"synthetic": {"fail_runs": ["r1"]}})
    bp = BatchProcessor(ctx, executor_type=executor, on_error="raise", max_workers=1)
    with pytest.raises(RuntimeError, match="r1 failed" if executor == "thread"
                       else "synthetic failure for r1"):
        bp.process_runs(["r1", "r2"], "synthetic")


@pytest.mark.parametrize("executor", ["thread", "device"])
def test_retries(tmp_path, executor):
    """Transient failures recover within the retry budget; under the device
    executor the batched attempt fails as a whole and the runs are retried
    one by one on the same Context."""
    FlakyPlugin.attempts = {}
    c = Context(storage_dir=str(tmp_path / "s"), config={"show_progress": False,
                                                         "device": "cpu"})
    c.register(FlakyPlugin())
    result = BatchProcessor(c, executor_type=executor, max_workers=1, retries=3,
                            on_error="continue").process_runs(["ok", "bad"], "flaky")
    assert sorted(result.succeeded) == ["bad", "ok"]
    assert FlakyPlugin.attempts["bad"] == 3
    # the device executor's batched call was the first attempt
    assert result.get("bad").attempts == (3 if executor == "thread" else 2)


@pytest.mark.parametrize("executor", ["thread", "device"])
def test_cancelled_before_start(ctx, executor):
    token = CancellationToken()
    token.cancel()
    result = BatchProcessor(ctx, executor_type=executor).process_runs(
        ["r1", "r2"], "synthetic", cancellation_token=token)
    assert result.cancelled and result.succeeded == []


def test_polling_mode_progress_and_cancellation(ctx):
    """The reference's polling (Jupyter) mode: wake every interval, report
    on_progress(done, total), stay cancellable while workers run."""
    seen = []
    result = BatchProcessor(ctx, max_workers=2).process_runs(
        ["r1", "r2", "r3"], "synthetic", poll_interval_s=0.01,
        on_progress=lambda done, total: seen.append((done, total)))
    assert sorted(result.succeeded) == ["r1", "r2", "r3"]
    assert seen and all(t == 3 for _, t in seen) and seen[-1][0] == 3

    token = CancellationToken()

    def cancel_after_first(done, total):
        if done >= 1:
            token.cancel()

    result = BatchProcessor(ctx, max_workers=1).process_runs(
        ["q1", "q2", "q3", "q4"], "synthetic", cancellation_token=token,
        poll_interval_s=0.01, on_progress=cancel_after_first)
    assert result.cancelled and len(result.succeeded) < 4


def test_config_grid(ctx):
    """Each (run, variant) cell computes under its own config, and the
    sweep leaves the base Context's config unchanged; the device executor
    refuses a grid."""
    before = ctx.get_config("synthetic", "scale")
    result = BatchProcessor(ctx, max_workers=2).process_runs_with_config_grid(
        ["rA", "rB"], "synthetic",
        config_grid=[{"synthetic": {"scale": f}} for f in (1.0, 2.0, 3.0)])
    assert sorted(result.results) == [f"r{x}#{i}" for x in "AB" for i in range(3)]
    for x in "AB":
        v = [np.asarray(result.get(f"r{x}#{i}").data["v"])[0] for i in range(3)]
        assert v == [sum(f"r{x}".encode()) * f for f in (1.0, 2.0, 3.0)]
    assert ctx.get_config("synthetic", "scale") == before
    with pytest.raises(ValueError, match="config-grid"):
        BatchProcessor(ctx, executor_type="device").process_runs_with_config_grid(
            ["rA"], "synthetic", [{"synthetic": {"scale": 2.0}}])


def test_process_func_summary_and_validation(ctx):
    result = BatchProcessor(ctx, max_workers=2).process_func(
        ["a", "b", "c"], lambda c, r: r * 2)
    assert sorted(result.get(r).data for r in result.succeeded) == ["aa", "bb", "cc"]

    ctx.set_config({"synthetic": {"fail_runs": ["bad"]}})
    text = BatchProcessor(ctx).process_runs(["ok", "bad"], "synthetic").summary()
    assert "1 succeeded, 1 failed" in text and "FAILED bad" in text
    with pytest.raises(ValueError):
        BatchProcessor(ctx, on_error="explode")
    with pytest.raises(ValueError):
        BatchProcessor(ctx, executor_type="fiber")
