"""``basic_features_from_waves`` and ``find_hit_runs`` of the port against
the JAX package's, on the cases of tests/test_basic_features.py.

The same inputs, made from a seed with numpy, go through each package's
function on the CPU; the exact host combine must be equal bit for bit, the
float32 device combine equal to JAX's within 1e-5 relative.
"""

import numpy as np
import pytest

from waveformanalysis_tpu.ops import features as JF
from waveformanalysis_tpu.ops import hits as JH
from waveformanalysis_tpu_torch.ops import features as TF
from waveformanalysis_tpu_torch.ops import hits as TH


def both(*args, **kw):
    want = JF.basic_features_from_waves(*args, **kw)
    got = TF.basic_features_from_waves(*args, device="cpu", **kw)
    assert sorted(got) == sorted(want) == ["amp", "area", "height", "max_abs_diff"]
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
    return want, got


@pytest.mark.parametrize("polarity", ["negative", "positive"])
@pytest.mark.parametrize("height_range,area_range", [
    ((40, 90), (0, None)),
    ((0, None), (10, 100)),
    ((0, 5), (0, 5)),
    ((-30, None), (-100, -10)),
])
def test_equals_jax(polarity, height_range, area_range):
    rng = np.random.default_rng(7)
    n, L = 64, 128
    waves = rng.integers(500, 1500, size=(n, L)).astype(np.int16)
    baselines = 1000.0 + rng.normal(0, 3, n)
    pol = np.full(n, 1 if polarity == "positive" else -1, dtype=np.int8)
    el = np.full(n, L, dtype=np.int32)
    el[::7] = rng.integers(1, L, len(el[::7]))
    want, got = both(waves, el, baselines, pol,
                     height_range=height_range, area_range=area_range)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_variable_event_length():
    """Padding beyond event_length does not leak into the features."""
    n, L = 8, 64
    waves = np.full((n, L), 1000, dtype=np.int16)
    waves[:, 30:40] = 800
    waves[:, 50:] = -30000
    want, got = both(waves, np.full(n, 50, np.int32), np.full(n, 1000.0),
                     np.full(n, -1, np.int8))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["area"], np.full(n, 2000.0, np.float32))
    assert got["max_abs_diff"].max() == 200.0


def test_empty_window_gives_zero():
    n, L = 4, 32
    waves = np.full((n, L), 1000, dtype=np.int16)
    want, got = both(waves, np.full(n, L, np.int32), np.full(n, 1000.0),
                     np.full(n, -1, np.int8), height_range=(40, 90))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["height"], np.zeros(n, np.float32))


def test_device_combine_equals_jax():
    rng = np.random.default_rng(3)
    n, L = 32, 256
    waves = rng.integers(0, 4000, size=(n, L)).astype(np.int16)
    baselines = 2000.0 + rng.normal(0, 5, n)
    pol = np.where(rng.random(n) < 0.5, 1, -1).astype(np.int8)
    el = np.full(n, L, np.int32)
    want, got = both(waves, el, baselines, pol, host_combine=False)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0, err_msg=k)
    exact, _ = both(waves, el, baselines, pol, host_combine=True)
    np.testing.assert_allclose(got["area"], exact["area"], rtol=1e-5, atol=0.5)


def test_long_rows_refused():
    waves = np.zeros((1, 65536), np.int16)
    args = (waves, np.array([65536], np.int32), np.zeros(1), np.ones(1, np.int8))
    with pytest.raises(ValueError, match="65536") as want:
        JF.basic_features_from_waves(*args)
    with pytest.raises(ValueError, match="65536") as got:
        TF.basic_features_from_waves(*args, device="cpu")
    assert str(got.value) == str(want.value)


def test_default_device_is_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TF.basic_features_from_waves(np.zeros((2, 8), np.int16), np.full(2, 8, np.int32),
                                     np.zeros(2), np.ones(2, np.int8))


@pytest.mark.parametrize("shape,p", [((1, 1), 0.5), ((16, 40), 0.3), ((16, 40), 0.9),
                                     ((5, 0), 0.5), ((0, 7), 0.5)])
def test_find_hit_runs_equals_jax(shape, p):
    rng = np.random.default_rng(11)
    mask = rng.random(shape) < p
    want = JH.find_hit_runs(mask)
    got = TH.find_hit_runs(mask)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
