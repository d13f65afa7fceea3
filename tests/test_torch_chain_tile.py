"""The tile chain (K7) of the PyTorch/CUDA port, its facade and its demo.

On CPU tensors ``chain_tile_cuda`` runs its plain version,
``full_chain_step``; three cases hold it against the JAX package's Pallas
tile kernel ``chain_pallas`` in interpret mode on the same numpy inputs
(n = 50 events, not a multiple of the 32-row tile). Tolerance: integer,
index, count and label outputs exact; float32 outputs atol 1e-3 / rtol
1e-4 (the chain's f32 sums, such as ``hit_integral``, reduce in another
order in each implementation). JAX is imported inside the tests that use
it, so on a GPU machine without JAX this file runs on its own:
``python -m pytest --noconftest -q -m cuda tests/test_torch_chain_tile.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import waveformanalysis_tpu_torch as wa
from waveformanalysis_tpu_torch.models import full_chain as tchain
from waveformanalysis_tpu_torch.ops import chain_tile_cuda as ctc

ATOL, RTOL = 1e-3, 1e-4
N, L = 50, 192


def _mixed_waves(n, length, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(length)
    waves = np.full((n, length), 1000.0)
    for i in range(n):
        c = rng.integers(50, length - 50)
        amp = rng.choice([300, -280]) if i % 5 else 0
        waves[i] += amp * np.exp(-((t - c) ** 2) / (2 * rng.uniform(2, 20) ** 2))
    waves += rng.normal(0, 3, waves.shape)
    return np.round(waves).astype(np.int16)


RNG = np.random.default_rng(11)
WAVES = _mixed_waves(N, L)
EL = RNG.integers(L // 2, L + 1, N).astype(np.int32)
BL = np.full(N, 1000.0, np.float32)
POS = np.ones(N, np.int8)
NOISY = (1000 + RNG.normal(0, 40, (N, L))).round().astype(np.int16)
MIXED_POL = RNG.choice(np.array([-1, 1], np.int8), N)

PALLAS_CASES = {
    "positive_polarity_ragged": (
        dict(use_derivative=False, peak_height=60.0, peak_prominence=30.0, peak_width=1.5),
        WAVES, POS),
    "derivative_distance3_mixed_polarity": (
        dict(use_derivative=True, peak_height=20.0, peak_prominence=5.0, peak_width=1.0,
             peak_distance=3), WAVES, MIXED_POL),
    "dense_noise_k16": (
        dict(use_derivative=False, peak_height=10.0, peak_prominence=2.0, peak_width=0.5,
             peak_distance=1, max_peaks=16, max_hits=16, hit_threshold=5.0), NOISY, POS),
}


def _assert_same(ref, out, tag=""):
    assert list(out) == list(ref), tag
    for k in ref:
        a, b = np.asarray(ref[k]), out[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (tag, k, a.dtype, b.dtype)
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a, err_msg=f"{tag}/{k}")
        else:
            np.testing.assert_allclose(b, a, atol=ATOL, rtol=RTOL, err_msg=f"{tag}/{k}")


@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_chain_tile_matches_pallas_interpret(case):
    import jax.numpy as jnp

    from waveformanalysis_tpu.models.full_chain import ChainConfig as JaxChainConfig
    from waveformanalysis_tpu.ops.chain_pallas import chain_pallas

    fields, waves, pol = PALLAS_CASES[case]
    jcfg = JaxChainConfig(**fields)
    tcfg = wa.ChainConfig.from_fields(dataclasses.asdict(jcfg))
    ref = chain_pallas(jnp.asarray(waves), jnp.asarray(EL), jnp.asarray(BL), jnp.asarray(pol),
                       jcfg, tile_rows=32, interpret=True)
    before = ctc.chain_tile_cuda.launches
    out = ctc.chain_tile_cuda(*wa.batch_from_numpy(waves, EL, BL, pol, device="cpu"), tcfg)
    assert ctc.chain_tile_cuda.launches == before
    _assert_same({k: ref[k] for k in out}, out, case)
    assert set(out) == set(ref)
    assert int(out["n_peaks"].sum()) > 0 and int(out["n_hits"].sum()) > 0


def test_cpu_tensors_run_the_plain_chain(monkeypatch):
    """On CPU tensors: no build, no launch, and full_chain_step's outputs
    key for key and dtype for dtype."""
    from waveformanalysis_tpu_torch.kernels import _build

    def refuse(*args):
        raise AssertionError("the loader was called for CPU tensors")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(ctc, "_library", refuse)
    cfg = wa.ChainConfig(use_derivative=False, peak_height=60.0, peak_prominence=30.0,
                         peak_width=1.5)
    batch = wa.batch_from_numpy(WAVES, EL, BL, MIXED_POL, device="cpu")
    before = ctc.chain_tile_cuda.launches
    out = wa.make_chain_tile(cfg, tile_rows=3)(*batch)
    ref = wa.full_chain_step(*batch, cfg)
    assert ctc.chain_tile_cuda.launches == before
    assert list(out) == list(ref)
    for k in ref:
        assert out[k].dtype == ref[k].dtype and torch.equal(out[k], ref[k]), k


def test_wrapper_rejects_bad_inputs_before_building(monkeypatch):
    """The kernel's input checks raise before any build (no nvcc needed)."""
    monkeypatch.setattr(ctc, "_library", lambda: pytest.fail("built too early"))
    w = torch.zeros((4, 64), dtype=torch.int16)
    el = torch.full((4,), 64, dtype=torch.int32)
    bl = torch.zeros(4)
    pol = torch.ones(4, dtype=torch.int8)
    cfg = wa.ChainConfig()
    with pytest.raises(TypeError, match="int16"):
        ctc._launch(w.to(torch.int32), el, bl, pol, cfg, 8)
    with pytest.raises(ValueError, match="contiguous"):
        ctc._launch(torch.zeros((64, 4), dtype=torch.int16).t(), el, bl, pol, cfg, 8)
    with pytest.raises(ValueError, match="shape"):
        ctc._launch(w, el[:3], bl, pol, cfg, 8)
    with pytest.raises(ValueError, match="slots"):
        ctc._launch(w, el, bl, pol, wa.ChainConfig(max_hits=33), 8)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ctc.chain_tile_cuda(w.to("meta"), el, bl, pol)
    with pytest.raises(ValueError, match="tile_rows"):
        ctc._launch(w, el, bl, pol, cfg, 33)
    with pytest.raises(ValueError, match="tile_rows"):
        wa.make_chain_tile(cfg, tile_rows=0)
    long_w = torch.zeros((1, ctc.MAX_WAVE_LENGTH + 1), dtype=torch.int16)
    with pytest.raises(ValueError, match="L < 65536"):
        ctc._launch(long_w, el[:1], bl[:1], pol[:1], cfg, 8)


def test_shared_memory_limits():
    """K7's layout: per warp the int16 row and, where it is kept, the
    float32 signal row, each padded to 16 bytes, and four 32-entry slot
    tables. The float row fits up to MAX_FLOAT_ROW_LENGTH (one event of it
    fills a block exactly), but is kept only where it leaves as many warps
    on an SM as the int16 row alone (test below); every L the chain takes
    (L < 65,536) runs on the int16 row. Rows per block drop where tile_rows
    rows do not fit, down to one at the longest row."""
    from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc

    assert ctc.event_smem_bytes(256, True) == 512 + 1024 + 512
    assert ctc.event_smem_bytes(256, False) == 512 + 512 == csc.row_layout(
        256, 2, 0, csc.CHAIN_SLOT_BYTES).smem_bytes // 8  # K1's warp
    assert ctc.event_smem_bytes(250, True) == 512 + 1008 + 512
    top = ctc.MAX_FLOAT_ROW_LENGTH
    assert ctc.event_smem_bytes(top, True) == ctc.SMEM_BYTES
    assert ctc.event_smem_bytes(top + 1, True) > ctc.SMEM_BYTES
    assert top > 28_113  # the earlier float32 w / x layout's limit
    assert ctc._layout(top, 8, True) == ctc.TileLayout(1, True, ctc.SMEM_BYTES)
    assert ctc.tile_layout(256, ctc.DEFAULT_TILE_ROWS) == ctc.TileLayout(8, True, 8 * 2048)
    assert ctc.tile_layout(256, 32) == ctc.TileLayout(32, True, 32 * 2048)
    assert ctc.tile_layout(top, 8) == ctc.TileLayout(
        2, False, 2 * ctc.event_smem_bytes(top, False))
    assert ctc.tile_layout(top + 1, 8) == ctc.TileLayout(
        2, False, 2 * ctc.event_smem_bytes(top + 1, False))
    assert ctc.tile_layout(20_000, 8).rows == ctc.SMEM_BYTES // ctc.event_smem_bytes(
        20_000, False) == 5
    assert ctc.tile_layout(ctc.MAX_WAVE_LENGTH, 32) == ctc.TileLayout(
        1, False, ctc.event_smem_bytes(65_535, False))
    assert ctc.MAX_WAVE_LENGTH == 65_535
    with pytest.raises(ValueError, match="L <= 65535"):
        ctc.tile_layout(ctc.MAX_WAVE_LENGTH + 1, 8)


def test_float_row_kept_only_where_it_keeps_the_warps():
    """The float32 row costs 4 L bytes of shared memory a warp; K7 keeps it
    only where the SM still holds as many of its warps as with the int16
    row alone. With 50 registers a thread (1,792 a warp) an SM holds 36
    warps, so 8-warp blocks stop at four (32 warps) in both modes up to L =
    1,108; from 1,109 the float row leaves three blocks (24 warps) against
    four."""
    assert ctc.TILE_REGISTERS == 50
    assert ctc.warps_per_sm(ctc.TileLayout(8, True, 8 * 2048)) == 32  # registers
    assert ctc.warps_per_sm(ctc.TileLayout(32, True, 32 * 2048)) == 32  # one block
    assert ctc.warps_per_sm(ctc.TileLayout(1, True, ctc.SMEM_BYTES)) == 1  # shared memory
    # shared memory: (233,472 bytes) // (block + 1,024) blocks
    assert ctc.warps_per_sm(ctc.TileLayout(8, False, 69_632)) == 24
    assert ctc.SM_SMEM_BYTES // (69_632 + ctc.SM_BLOCK_RESERVED) == 3
    edge = 1_108
    for L, float_row in ((256, True), (edge, True), (edge + 1, False), (4_096, False)):
        lay = ctc.tile_layout(L, 8)
        int16 = ctc._layout(L, 8, False)
        assert lay.float_row == float_row, L
        assert ctc.warps_per_sm(lay) == ctc.warps_per_sm(int16) == 32 if L <= edge else 24
        if not float_row:
            assert ctc.warps_per_sm(ctc._layout(L, 8, True)) < ctc.warps_per_sm(int16)
    assert ctc.warps_per_sm(ctc._layout(4_096, 8, True)) == 8  # one 200,704-byte block
    # 32-warp blocks: one block an SM in both modes while the float row fits 32 rows
    assert ctc.tile_layout(1_120, 32) == ctc.TileLayout(32, True, 32 * 7_232)
    assert not ctc.tile_layout(1_120, 1).float_row  # 28 one-warp blocks against 32


def test_tile_wrapper_hands_over_the_layout(monkeypatch):
    """chain_tile_cuda hands K7 the event-major rows it was given (no
    transposing copy) with tile_layout's rows and row choice: checked with a
    stand-in library on CPU tensors posing as CUDA tensors."""
    import contextlib

    seen = {}

    class Lib:
        def wfa_chain_tile(self, w, el, bl, pol, outs, prm, rows, vec, float_row, stream):
            seen["tile"] = (w, rows, vec, float_row, prm._obj.L)
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(ctc, "_library", Lib)
    monkeypatch.setattr(ctc, "_devices", lambda *ts: "cuda")
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    before = ctc.chain_tile_cuda.launches
    for L, rows, float_row in ((256, 8, 1), (250, 3, 1), (40_000, 8, 0)):
        waves = torch.zeros((4, L), dtype=torch.int16)
        el = torch.full((4,), L, dtype=torch.int32)
        ctc.chain_tile_cuda(waves, el, torch.zeros(4), torch.ones(4, dtype=torch.int8),
                            tile_rows=rows)
        lay = ctc.tile_layout(L, rows)
        vec = int(L % 8 == 0 and waves.data_ptr() % 16 == 0)
        assert seen["tile"] == (waves.data_ptr(), lay.rows, vec, float_row, L)
    assert ctc.chain_tile_cuda.launches == before + 3


def test_fused_chain_demo_on_cpu():
    from waveformanalysis_tpu_torch.examples import fused_chain_demo

    result = fused_chain_demo.main(device="cpu", n_events=64)
    assert result["agree"] == {"tile-cuda": True, "scan-cuda": True}
    for name, r in result["results"].items():
        # even events carry the narrow S1 pulse, odd events the wide S2
        assert (r["accuracy"], r["n_s1"], r["n_s2"]) == (1.0, 32, 32), name


# JAX facade names whose modules the port does not have yet (ROADMAP
# Queue 1: multi-device, surface)
NOT_YET_PORTED = (
    "wrap_strax_plugin", "StraxContextAdapter", "PluginLoader", "enable_hot_reload",
    "PluginHotReloader", "make_sharded_chain",
    "make_sharded_chain_pallas", "make_sharded_chain_scan",
    "parse_and_stack_files", "WaveformPreviewer", "preview_waveforms",
    "plot_records_waveforms", "plot_lineage_labview", "plot_lineage_plotly",
    "plot_waveforms", "create_interactive_browser", "LineageStyle",
)
# JAX facade name -> the port's name for it (kernel-named chain entries and
# the TPU-named default profile)
MAPPED = {
    "make_jit_chain": "make_chain",
    "make_jit_chain_scan": "make_chain_scan",
    "chain_scan_pallas": "chain_scan_cuda",
    "make_jit_chain_pallas": "make_chain_tile",
    "chain_pallas": "chain_tile_cuda",
    "tpu_default": "cuda_default",
}


def test_facade_covers_the_jax_facade():
    """Each JAX facade name is in exactly one group: on the port's facade
    under its own name, mapped to a port name, or not yet ported; every
    port facade name resolves, and a name not yet ported raises."""
    import waveformanalysis_tpu as jwa

    jax_names = set(jwa._LAZY_API)
    groups = [set(wa._LAZY_API) & jax_names, set(MAPPED), set(NOT_YET_PORTED)]
    assert len(NOT_YET_PORTED) == len(set(NOT_YET_PORTED))
    for name in jax_names:
        assert sum(name in g for g in groups) == 1, name
    assert set().union(*groups) == jax_names
    assert set(MAPPED.values()) <= set(wa._LAZY_API)
    assert not set(MAPPED) & set(wa._LAZY_API)
    for name in wa._LAZY_API:
        assert getattr(wa, name) is not None, name
    assert wa.make_chain_tile is ctc.make_chain_tile
    assert wa.chain_tile_cuda is ctc.chain_tile_cuda
    assert sorted(dir(wa)) == sorted(wa.__all__)
    for name in NOT_YET_PORTED[:3] + tuple(MAPPED):
        with pytest.raises(AttributeError, match=name):
            getattr(wa, name)


@pytest.mark.cuda
def test_tile_kernel_matches_plain_on_card():
    """K7 against the plain version on CUDA tensors: a ragged last block,
    rows that are not 16-byte aligned, 1..32 events per block, 8 to 32
    slots; its integer outputs also equal K1's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    from waveformanalysis_tpu_torch.ops.chain_scan_cuda import chain_scan_cuda

    rng = np.random.default_rng(4)
    n = 1003
    for length, rows, cfg in (
        (192, 8, wa.ChainConfig(use_derivative=False, peak_height=40.0,
                                peak_prominence=10.0, peak_width=1.0)),
        (189, 3, wa.ChainConfig()),
        (200, 32, wa.ChainConfig(max_peaks=32, max_hits=16, peak_distance=3)),
    ):
        waves = np.round(1000 + rng.normal(0, 30, (n, length))).astype(np.int16)
        waves[:, 80:90] += 200
        el = rng.integers(length // 2, length + 1, n).astype(np.int32)
        pol = rng.choice(np.array([-1, 0, 1], np.int8), n)
        batch = wa.batch_from_numpy(waves, el, np.full(n, 1000.0, np.float32), pol,
                                    device="cuda")
        before = ctc.chain_tile_cuda.launches
        out = ctc.chain_tile_cuda(*batch, cfg, tile_rows=rows)
        torch.cuda.synchronize()
        assert ctc.chain_tile_cuda.launches == before + 1
        ref = wa.full_chain_step(*batch, cfg)
        k1 = chain_scan_cuda(*batch, cfg)
        assert list(out) == list(ref)
        for k in ref:
            a, b = ref[k].cpu().numpy(), out[k].cpu().numpy()
            assert a.dtype == b.dtype, k
            if np.issubdtype(a.dtype, np.integer):
                np.testing.assert_array_equal(b, a, err_msg=k)
                np.testing.assert_array_equal(b, k1[k].cpu().numpy(), err_msg=k)
            else:
                np.testing.assert_allclose(b, a, atol=ATOL, rtol=RTOL, err_msg=k)
