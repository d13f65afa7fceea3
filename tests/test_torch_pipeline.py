"""The port's fused feature pipeline (``models/pipeline.py``) against the JAX
package's, on the CPU.

The same numpy batches go through both: ``example_batch`` and a seeded batch
with ragged ``event_length`` and mixed polarity, through ``forward_step``,
``make_jit_step`` and, on an 8-shard CPU mesh against JAX's 8 virtual
devices (tests/test_torch_parallel.py's meshes), ``make_sharded_step``.

Tolerance: integer, count and label outputs exact; float32 outputs atol 1e-3
/ rtol 1e-4 (sums taken in another order than XLA's); ``run_stats`` counts
exact, its total area (a float32 sum per shard, then over the shards) rtol
1e-4.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from waveformanalysis_tpu.models import pipeline as jp
from waveformanalysis_tpu.parallel import mesh as jmesh
from waveformanalysis_tpu_torch.models import pipeline as tp
from waveformanalysis_tpu_torch.parallel import mesh as tmesh

ATOL, RTOL = 1e-3, 1e-4


def _ragged_batch(n=200, L=96, seed=11):
    """Pulses of both polarities on a 1000 ADC baseline, ragged valid
    lengths (a few shorter than the baseline and height windows), some
    events without a pulse."""
    rng = np.random.default_rng(seed)
    t = np.arange(L)
    amp = rng.choice([-260.0, 240.0, 0.0], n)
    c = rng.integers(35, 70, n)
    width = rng.uniform(1.5, 15.0, n)
    waves = 1000.0 + amp[:, None] * np.exp(-((t[None, :] - c[:, None]) ** 2)
                                           / (2 * width[:, None] ** 2))
    waves = np.round(waves + rng.normal(0, 4, waves.shape)).astype(np.int16)
    event_length = rng.integers(10, L + 1, n).astype(np.int32)
    pol = np.where(amp > 0, 1, -1).astype(np.int8)
    pol[::7] = 0  # code 0 counts as negative, as in JAX
    return waves, event_length, pol


def _same(got, ref, keys=tp.OUT_KEYS):
    for k in keys:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.shape == r.shape and g.dtype == r.dtype, (k, g.dtype, r.dtype)
        if r.dtype.kind == "f":
            np.testing.assert_allclose(g, r, atol=ATOL, rtol=RTOL, err_msg=k)
        else:
            np.testing.assert_array_equal(g, r, err_msg=k)


def test_constants_and_config_are_the_jax_packages():
    assert tp.PIPELINE_VERSION == jp.PIPELINE_VERSION
    tcfg, jcfg = tp.PipelineConfig(), jp.PipelineConfig()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert hash(tcfg) == hash(jcfg)
    other = dict(hit_threshold=12.0, baseline_window=(2, 30))
    assert hash(tp.PipelineConfig(**other)) == hash(jp.PipelineConfig(**other))
    assert tuple(jp.forward_step(*jp.example_batch(8, 64), jcfg)) == tp.OUT_KEYS


def test_example_batch_is_the_jax_batch():
    got = tp.example_batch(64, 100, seed=3, device="cpu")
    for g, r in zip(got, jp.example_batch(64, 100, seed=3)):
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        assert g.numpy().dtype == np.asarray(r).dtype
    if torch.cuda.is_available():
        assert tp.example_batch(8, 64)[0].device.type == "cuda"
    else:  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            tp.example_batch(8, 64)


@pytest.mark.parametrize("case", ["example_batch", "ragged_mixed_polarity"])
@pytest.mark.parametrize("cfg_fields", [{}, {"hit_threshold": 12.0, "area_start": 30,
                                             "baseline_window": (5, 25),
                                             "height_range": (30, 120)}])
def test_forward_step_matches_jax(case, cfg_fields):
    batch = (tuple(np.array(a) for a in jp.example_batch(256, 128, seed=0))
             if case == "example_batch" else _ragged_batch())
    jcfg, tcfg = jp.PipelineConfig(**cfg_fields), tp.PipelineConfig(**cfg_fields)
    ref = jax.device_get(jp.forward_step(*batch, jcfg))
    got = tp.forward_step(*(torch.from_numpy(a) for a in batch), tcfg)
    assert all(v.device.type == "cpu" for v in got.values())
    _same(got, ref)
    labels = got["label"].numpy()
    assert (labels == 1).any() or (labels == 2).any()
    # the eager step closure is the same function
    step = tp.make_jit_step(tcfg)
    for k, v in step(*(torch.from_numpy(a) for a in batch)).items():
        assert torch.equal(v, got[k]), k


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return tmesh.make_mesh(devices=[torch.device("cpu")] * 8), jmesh.make_mesh(8)


@pytest.mark.multidevice
@pytest.mark.parametrize("case", ["example_batch", "ragged_mixed_polarity"])
def test_sharded_step_matches_jax(meshes, case):
    mesh, jm = meshes
    batch = (tuple(np.array(a) for a in jp.example_batch(256, 128, seed=1))
             if case == "example_batch" else _ragged_batch(n=192))
    ref = jax.device_get(jp.make_sharded_step(jm)(*batch))
    got = tp.make_sharded_step(mesh)(*(torch.from_numpy(a) for a in batch))
    assert set(got) == set(ref)
    _same(got, ref)
    assert isinstance(got["label"], tmesh.ShardedTensor) and len(got["label"].shards) == 8
    stats, ref_stats = got["run_stats"], np.asarray(ref["run_stats"])
    assert stats.dtype == torch.float32 and stats.shape == (3,)
    np.testing.assert_array_equal(stats[:2].numpy(), ref_stats[:2])
    np.testing.assert_allclose(stats[2].numpy(), ref_stats[2], rtol=RTOL)
    # = the one-device step, the statistics the shard sums
    one = tp.forward_step(*(torch.from_numpy(a) for a in batch), tp.PipelineConfig())
    for k in tp.OUT_KEYS:
        np.testing.assert_array_equal(np.asarray(got[k]), one[k].numpy(), err_msg=k)
    labels = one["label"].numpy()
    assert stats[:2].tolist() == [float((labels == 1).sum()), float((labels == 2).sum())]


@pytest.mark.multidevice
def test_sharded_step_needs_a_shard_multiple(meshes):
    mesh, _ = meshes
    batch = tp.example_batch(60, 64, device="cpu")
    with pytest.raises(ValueError, match="not a multiple of the 8 shards"):
        tp.make_sharded_step(mesh)(*batch)
