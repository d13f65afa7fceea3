"""The V1725 device unpack on the CPU, against the host walker and the JAX package.

The port's ``ops/v1725_device.py`` walks the headers on the host and
gathers the samples as torch ops on a device (here the CPU): every column
of ``st_waveforms`` with ``device_unpack=True`` must be bit-identical to
the host walker's and to the JAX package's device unpack, across sign
extension, truncation flags, several files, ``wave_length`` clipping and
several upload groups. Also here: the header walk (native and Python)
against the JAX package's, the vectorised V1725 writer against
``tests/utils.py``'s, and the refusal of a ``device="cuda"`` unpack
without a GPU.
"""

import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from utils import make_v1725_event
from utils import write_v1725_run as write_v1725_run_utils
from waveformanalysis_tpu.context.context import Context as JContext
from waveformanalysis_tpu.ops import v1725_device as jdev
from waveformanalysis_tpu.plugins.builtin import waveforms as jwf
from waveformanalysis_tpu_torch.context.context import Context as TContext
from waveformanalysis_tpu_torch.formats.v1725 import V1725Reader
from waveformanalysis_tpu_torch.native import scan_v1725_headers_bytes
from waveformanalysis_tpu_torch.ops import v1725_device as tdev
from waveformanalysis_tpu_torch.plugins.builtin import waveforms as twf
from waveformanalysis_tpu_torch.testing.fixtures import write_v1725_run


def _blob(seed: int, n_events: int = 40, trunc_every: int = 0) -> bytes:
    """Events of 1-3 random channels, random even lengths, extreme and
    random samples, 48-bit timestamps, 16-bit baselines; every
    ``trunc_every``-th event flagged truncated."""
    rng = np.random.default_rng(seed)
    out = b""
    for i in range(n_events):
        chans = rng.choice(16, size=int(rng.integers(1, 4)), replace=False)
        waves = {}
        for c in chans:
            w = rng.integers(-32768, 32768, 2 * int(rng.integers(2, 30))).astype(np.int16)
            w[:2] = (-32768, 32767)
            waves[int(c)] = w
        out += make_v1725_event(
            waves, timestamps={int(c): int(rng.integers(0, 2**47)) for c in chans},
            baselines={int(c): int(rng.integers(0, 65535)) for c in chans},
            trunc=bool(trunc_every and i % trunc_every == 0))
    return out


def test_unpack_matches_frombuffer_and_jax():
    """Each row is the record's little-endian int16 samples, zero past its
    length; the JAX package's unpack gives the same matrix."""
    blob = _blob(3)
    meta = tdev.scan_headers(blob, board=2)
    L = int(meta["n_samples"].max())
    got = tdev.unpack_samples_device(np.frombuffer(blob, np.uint8), meta["offset"],
                                     meta["n_samples"], L, device="cpu")
    assert got.dtype == torch.int16 and got.shape == (len(meta["offset"]), L)
    got = got.numpy()
    for i, (off, n) in enumerate(zip(meta["offset"], meta["n_samples"])):
        np.testing.assert_array_equal(got[i, :n], np.frombuffer(blob, "<i2", n, off))
        assert np.all(got[i, n:] == 0)
    ref = jdev.unpack_samples_device(np.frombuffer(blob, np.uint8), meta["offset"],
                                     meta["n_samples"], L)
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("L", [6, 4, 3, 1])
def test_odd_offsets_negative_samples_and_truncation(L):
    """Different-length records shift later sample starts across 4-byte
    words; sign extension holds for extreme values; L below a record's
    length truncates the row (the JAX package's matrix at every L)."""
    w0 = np.array([-32768, 32767, -1, 1, 0, -12345], dtype=np.int16)
    w1 = np.array([100, -100, 32767, -32768], dtype=np.int16)
    blob = make_v1725_event({0: w0}) + make_v1725_event({1: w1})
    meta = tdev.scan_headers(blob, board=0)
    got = tdev.unpack_samples_device(blob, meta["offset"], meta["n_samples"], L,
                                     device="cpu").numpy()
    np.testing.assert_array_equal(got[0], w0[:L])
    np.testing.assert_array_equal(got[1], np.r_[w1, np.zeros(2, np.int16)][:L])
    ref = jdev.unpack_samples_device(np.frombuffer(blob, np.uint8), meta["offset"],
                                     meta["n_samples"], L)
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_read_only_bytes_unpack_without_a_warning():
    """The raw bytes (read-only) are copied once into a writable buffer:
    torch.from_numpy never sees a read-only array."""
    blob = _blob(5, n_events=4)
    meta = tdev.scan_headers(blob, board=0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tdev.unpack_samples_device(np.frombuffer(blob, np.uint8), meta["offset"],
                                   meta["n_samples"], 8, device="cpu")
        tdev.unpack_samples_device(blob, meta["offset"], meta["n_samples"], 8, device="cpu")


@pytest.mark.parametrize("tail", [b"", b"\x01\x02", b"\x00" * 20])
def test_header_scans_match_jax(tail):
    """The native scan and the Python oracle against the JAX package's,
    with truncation flags and malformed tails (the walk stops there)."""
    blob = _blob(7, trunc_every=3) + tail
    base = 100
    py = tdev._scan_headers_py(blob, board=4, base_offset=base)
    ref = jdev._scan_headers_py(blob, board=4, base_offset=base)
    native = scan_v1725_headers_bytes(blob)
    got = tdev.scan_headers(blob, board=4, base_offset=base)
    assert py.keys() == ref.keys() == got.keys()
    for k in ref:
        for out in (py, got):
            assert out[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(native["offset"] + base, ref["offset"])
    assert ref["trunc"].any() and not ref["trunc"].all()


def _contexts(tmp_path, root, **st_options):
    """Port Contexts with the host walk and with the device unpack, and the
    JAX package's device unpack."""
    out = []
    for cls, plugins, device, tag in (
            (TContext, twf, False, "host"), (TContext, twf, True, "dev"),
            (JContext, jwf, True, "jax")):
        config = {"show_progress": False, "data_root": str(root), "daq_adapter": "v1725"}
        if cls is TContext:
            config["device"] = "cpu"
        ctx = cls(storage_dir=str(tmp_path / tag), config=config)
        ctx.register(plugins.RawFileNamesPlugin(), plugins.WaveformsPlugin())
        ctx.set_config({"st_waveforms": {"device_unpack": device, **st_options}})
        out.append(ctx)
    return out


def _same_tables(tables):
    ref = tables[0]
    for out in tables[1:]:
        assert out.field_names == ref.field_names and len(out) == len(ref)
        for f in ref.field_names:
            a, b = np.asarray(ref[f]), np.asarray(out[f])
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def _raw_dir(root: Path) -> Path:
    raw = root / "r" / "RAW"
    raw.mkdir(parents=True, exist_ok=True)
    return raw


@pytest.mark.parametrize("case", ["one_file", "several_files", "truncated", "clipped"])
def test_st_waveforms_device_unpack_matches_host_and_jax(tmp_path, case):
    root = tmp_path / "daq"
    options = {}
    if case == "one_file":
        write_v1725_run(str(root), "r", n_events=6, n_samples=40)
    elif case in ("several_files", "clipped"):
        raw = _raw_dir(root)
        rng = np.random.default_rng(9)
        for seg in range(3):
            blob = b"".join(make_v1725_event(
                {0: rng.integers(-500, 500, 2 * int(rng.integers(8, 24))).astype(np.int16)},
                timestamps={0: seg * 10_000 + i}) for i in range(4))
            (raw / f"data_b1_seg{seg}.bin").write_bytes(blob)
        if case == "clipped":
            options["wave_length"] = 20  # shorter than most records: rows truncate
    else:
        _raw_dir(root).joinpath("data_b3_seg0.bin").write_bytes(
            _blob(11, n_events=12, trunc_every=4) + b"\x05")
    tables = [ctx.get_data("r", "st_waveforms") for ctx in _contexts(tmp_path, root, **options)]
    host, dev, _ = tables
    assert len(host) > 0 and isinstance(dev["wave"], np.ndarray)
    if case == "clipped":
        assert host["wave"].shape[1] == 20 and np.asarray(dev["event_length"]).max() == 20
    if case == "several_files":
        assert np.all(np.asarray(dev["board"]) == 1)
    _same_tables(tables)


def test_several_upload_groups_equal_one(tmp_path):
    """Files grouped into several uploads (a small group limit) give the
    matrix and metadata of one upload, offsets global."""
    raw = _raw_dir(tmp_path / "daq")
    for seg in range(4):
        raw.joinpath(f"x_b0_seg{seg}.bin").write_bytes(_blob(20 + seg, n_events=5))
    files = sorted(raw.iterdir())
    reader = V1725Reader()
    one, meta1 = tdev.read_files_device(files, board_from_path=reader._extract_board_from_path,
                                        device="cpu")
    many, meta4 = tdev.read_files_device(files, board_from_path=reader._extract_board_from_path,
                                         device="cpu", _group_limit=1)
    np.testing.assert_array_equal(one.numpy(), many.numpy())
    ref, jmeta = jdev.read_files_device(files, board_from_path=reader._extract_board_from_path)
    np.testing.assert_array_equal(one.numpy(), np.asarray(ref))
    for k in jmeta:
        for meta in (meta1, meta4):
            np.testing.assert_array_equal(meta[k], jmeta[k], err_msg=k)
    empty, meta0 = tdev.read_files_device([], device="cpu")
    assert empty is None and all(len(v) == 0 for v in meta0.values())


def test_the_wave_column_leaves_the_device_when_get_data_returns(tmp_path):
    """Inside the request st_waveforms' wave column is the unpack's tensor
    on the Context's device; get_data returns, and the memory cache keeps,
    a host array."""
    write_v1725_run(str(tmp_path / "daq"), "r", n_events=4, n_samples=32)
    _, ctx, _ = _contexts(tmp_path, tmp_path / "daq")
    seen = []
    compute = ctx._plugins["st_waveforms"].compute

    def spy(*args, **kwargs):
        out = compute(*args, **kwargs)
        seen.append(type(out["wave"]))
        return out

    ctx._plugins["st_waveforms"].compute = spy
    st = ctx.get_data("r", "st_waveforms")
    assert seen == [torch.Tensor]
    assert isinstance(st["wave"], np.ndarray)
    assert isinstance(ctx._results[("r", "st_waveforms")]["wave"], np.ndarray)


def test_unpack_refuses_cuda_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    blob = _blob(1, n_events=2)
    meta = tdev.scan_headers(blob, board=0)
    with pytest.raises(RuntimeError, match="cuda"):
        tdev.unpack_samples_device(blob, meta["offset"], meta["n_samples"], 8)


@pytest.mark.parametrize("n_events,n_samples,board", [(4, 32, 0), (7, 40, 3)])
def test_vectorised_writer_matches_tests_utils(tmp_path, n_events, n_samples, board):
    """testing.fixtures.write_v1725_run writes tests/utils.py's run byte
    for byte (file names included)."""
    a = write_v1725_run_utils(tmp_path / "a", run_name="r", n_events=n_events,
                              n_samples=n_samples, board=board)
    b = Path(write_v1725_run(str(tmp_path / "b"), "r", n_events=n_events, n_samples=n_samples,
                             board=board))
    files_a, files_b = sorted((a / "RAW").iterdir()), sorted((b / "RAW").iterdir())
    assert [f.name for f in files_a] == [f.name for f in files_b]
    assert all(x.read_bytes() == y.read_bytes() for x, y in zip(files_a, files_b))


def test_writer_arrays_read_back(tmp_path):
    """Arrays given to the writer come back through the host reader: the
    samples, 48-bit timestamps, baselines, channels, in order across files."""
    rng = np.random.default_rng(2)
    waves = {c: rng.integers(-3000, 3000, (12, 8)).astype(np.int16) for c in (2, 5)}
    ts = {2: rng.integers(0, 2**48, 12), 5: rng.integers(0, 2**48, 12)}
    root = Path(write_v1725_run(str(tmp_path), "r", n_events=12, n_samples=8, board=1,
                                waves=waves, timestamps=ts, baselines={2: 7, 5: 65535},
                                n_files=3))
    data = V1725Reader().read_files(sorted((root / "RAW").iterdir()))
    assert len(data) == 24
    np.testing.assert_array_equal(data["channel"], np.tile([2, 5], 12))
    np.testing.assert_array_equal(data["board"], np.full(24, 1))
    np.testing.assert_array_equal(np.stack(list(data["wave"])),
                                  np.stack([waves[2], waves[5]], 1).reshape(24, 8))
    np.testing.assert_array_equal(data["timestamp"], np.stack([ts[2], ts[5]], 1).reshape(-1))
    np.testing.assert_array_equal(data["baseline"], np.tile([7, 65535], 12))
