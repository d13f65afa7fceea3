"""The port's multi-device package (``parallel/``) and the sharded chains,
on an 8-shard CPU mesh against the JAX package on its 8 virtual devices.

The port's mesh is ``make_mesh(devices=[torch.device("cpu")] * 8)``, the
counterpart of the JAX tests' ``make_mesh(8)`` (tests/conftest.py forces 8
virtual CPU devices). The same inputs, made from seeds with numpy, go
through both packages: the mesh helpers, the halo pipeline, the sharded time
sort (JAX tests/test_sorted_merge.py's cases) and the three sharded chains
(``make_sharded_chain``, and the kernel entries, whose CPU path is the plain
chain, against JAX's ``make_sharded_chain_scan`` / ``make_sharded_chain_pallas``
in interpret mode at 8 shards x 8 events x 64 samples and 4 slots, which keeps
the interpret run near 10 s).

Tolerance: sorted columns, integer, index, label and count outputs exact;
float32 outputs atol 1e-3 / rtol 1e-4; ``total_area`` (a float32 sum per
shard, then over shards, in another order than JAX's) rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveformanalysis_tpu.models import full_chain as jfc
from waveformanalysis_tpu.ops.chain_pallas import make_sharded_chain_pallas
from waveformanalysis_tpu.ops.chain_scan_pallas import make_sharded_chain_scan as jax_chain_scan
from waveformanalysis_tpu.parallel import mesh as jmesh
from waveformanalysis_tpu.parallel import scan as jscan
from waveformanalysis_tpu.parallel import sorted_merge as jsort
import waveformanalysis_tpu_torch as wa
from waveformanalysis_tpu_torch import parallel as tpar
from waveformanalysis_tpu_torch.parallel import mesh as tmesh
from waveformanalysis_tpu_torch.parallel import scan as tscan
from waveformanalysis_tpu_torch.parallel import sorted_merge as tsort

pytestmark = pytest.mark.multidevice

ATOL, RTOL = 1e-3, 1e-4
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return tmesh.make_mesh(devices=CPU8), jmesh.make_mesh(8)


# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------


def test_parallel_all_is_the_jax_all():
    import waveformanalysis_tpu.parallel as jpar

    assert tpar.__all__ == jpar.__all__
    assert tsort.SORTED_MERGE_VERSION == jsort.SORTED_MERGE_VERSION


@pytest.mark.parametrize("kwargs, message", [
    ({"n_devices": 9}, "Requested 9 devices but only 8 available"),
    ({"axis_names": ("data", "channel")}, "shape required for multi-axis meshes"),
    ({"shape": (3,)}, r"Mesh shape \(3,\) != device count 8"),
])
def test_make_mesh_checks_as_jax(kwargs, message):
    with pytest.raises(ValueError, match=message):
        tmesh.make_mesh(devices=CPU8, **kwargs)
    with pytest.raises(ValueError, match=message):
        jmesh.make_mesh(devices=jax.devices()[:8], **kwargs)


def test_make_mesh_shapes_and_devices():
    mesh = tmesh.make_mesh(devices=CPU8, axis_names=("data", "channel"), shape=(4, 2))
    ref = jmesh.make_mesh(axis_names=("data", "channel"), shape=(4, 2))
    assert dict(mesh.shape) == dict(ref.shape) == {"data": 4, "channel": 2}
    assert list(mesh.shape.values()) == [4, 2] and mesh.size == 8
    assert mesh.shard_devices("data") == [torch.device("cpu")] * 4
    assert len(tmesh.make_mesh(3, devices=CPU8).shard_devices()) == 3
    with pytest.raises(ValueError, match="no axis 'x'"):
        mesh.shard_devices("x")
    # no card here: the default mesh and a CUDA device raise, never the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        tmesh.make_mesh(devices=["cuda:0"] * 2)
    with pytest.raises(ValueError, match="one type"):
        tmesh.Mesh(np.array([torch.device("cpu"), torch.device("meta")], dtype=object),
                   ("data",))
    assert tmesh.spread_devices("cpu", 3) == [torch.device("cpu")] * 3


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 300])
def test_pad_to_shards_and_shardings(n):
    assert tmesh.pad_to_shards(n, 8) == jmesh.pad_to_shards(n, 8)
    mesh = tmesh.make_mesh(devices=CPU8)
    assert tmesh.data_sharding(mesh).spec == ("data",)
    assert tmesh.replicated(mesh).spec == ()
    x = np.arange(2 * tmesh.pad_to_shards(n, 8), dtype=np.int32).reshape(-1, 2)
    st = tmesh.shard_rows(x, mesh)
    assert st.shape == x.shape and st.dtype == torch.int32 and len(st) == len(x)
    assert all(s.shape == (len(x) // 8, 2) for s in st.shards)
    np.testing.assert_array_equal(np.asarray(st), x)
    assert "PartitionSpec('data',)" in repr(st.sharding)
    assert tmesh.shard_rows(st, mesh) is st


def test_shard_rows_of_a_non_multiple_raises():
    with pytest.raises(ValueError, match="not a multiple of the 8 shards"):
        tmesh.shard_rows(np.zeros(9), tmesh.make_mesh(devices=CPU8))


# ---------------------------------------------------------------------------
# the halo pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [33, 64])
def test_halo_pipeline_matches_jax(meshes, n):
    """A 3-point moving sum across shard edges (zero halos at the open
    ends) with a summed statistic; ``n`` not a multiple of 8 pads."""
    mesh, jm = meshes
    x = np.random.default_rng(n).normal(0, 1, n).astype(np.float32)

    def jkernel(x, left_halo=None, right_halo=None):
        ext = jnp.concatenate([left_halo, x, right_halo])
        return {"smoothed": ext[:-2] + ext[1:-1] + ext[2:], "total": jnp.sum(x)}

    def tkernel(x, left_halo=None, right_halo=None):
        ext = torch.cat([left_halo, x, right_halo])
        return {"smoothed": ext[:-2] + ext[1:-1] + ext[2:], "total": x.sum()}

    keys = dict(n_inputs=1, out_keys=("smoothed", "total"), stats_keys=("total",), halo=1)
    (xs,) = tscan.shard_table_arrays(mesh, x)
    got = tscan.make_sharded_pipeline(mesh, tkernel, **keys)(xs)
    ref = jax.device_get(jscan.make_sharded_pipeline(jm, jkernel, **keys)(
        *jscan.shard_table_arrays(jm, x)))
    assert xs.shape[0] == jmesh.pad_to_shards(n, 8)
    np.testing.assert_allclose(np.asarray(got["smoothed"]), ref["smoothed"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(np.asarray(got["smoothed"])[:n],
                               np.convolve(x, [1, 1, 1], mode="same"), atol=ATOL, rtol=RTOL)
    assert got["total"].shape == () and np.isclose(float(got["total"]), ref["total"], rtol=RTOL)


def test_pipeline_missing_output_raises_as_jax(meshes):
    mesh, _ = meshes
    step = tscan.make_sharded_pipeline(mesh, lambda x: {"a": x}, 1, ("a", "b"))
    with pytest.raises(ValueError, match=r"sharded kernel missing outputs: \['b'\]"):
        step(np.zeros(8))
    with pytest.raises(ValueError, match="share the leading event axis"):
        tscan.shard_table_arrays(mesh, np.zeros(8), np.zeros(9))


def test_halo_exchange_ends_are_zero():
    shards = [torch.full((3, 2), float(i + 1)) for i in range(4)]
    left, right = tscan.shard_halo_exchange(shards, 2)
    assert torch.equal(left[0], torch.zeros(2, 2)) and torch.equal(right[3], torch.zeros(2, 2))
    for i in range(1, 4):
        assert torch.equal(left[i], torch.full((2, 2), float(i)))
        assert torch.equal(right[i - 1], torch.full((2, 2), float(i + 1)))


# ---------------------------------------------------------------------------
# the sharded time sort
# ---------------------------------------------------------------------------


def _sort_case(case, rng):
    """(cols, keys) of JAX tests/test_sorted_merge.py's cases."""
    if case == "random":
        n = 8 * 500
        return {"timestamp": rng.integers(10**14, 10**15, n).astype(np.int64),
                "record_id": rng.permutation(n).astype(np.int64),
                "area": rng.uniform(0, 100, n)}, ("timestamp", "record_id")
    if case == "duplicates":
        n = 8 * 128
        return {"timestamp": rng.integers(0, 20, n).astype(np.int64),
                "record_id": rng.permutation(n).astype(np.int64)}, ("timestamp", "record_id")
    if case == "time_ties_only":  # equal primary keys keep their input order
        n = 8 * 50 + 3
        return {"timestamp": rng.integers(0, 5, n).astype(np.int64),
                "value": np.arange(n, dtype=np.float32)}, ("timestamp",)
    if case == "non_multiple":
        n = 8 * 100 + 37
        return {"timestamp": rng.integers(10**12, 10**13, n).astype(np.int64),
                "record_id": np.arange(n, dtype=np.int64)}, ("timestamp", "record_id")
    if case == "segments":
        ts = np.concatenate([10**14 * (s + 1) + np.sort(rng.integers(0, 10**9, 700))
                             for s in range(3)])
        rng.shuffle(ts)
        n = len(ts)
        return {"timestamp": ts.astype(np.int64), "record_id": np.arange(n, dtype=np.int64),
                "channel": rng.integers(0, 4, n).astype(np.int64)}, (
                    "timestamp", "channel", "record_id")
    if case == "payload":
        n = 8 * 64
        return {"timestamp": rng.integers(0, 10**9, n).astype(np.int64),
                "record_id": np.arange(n, dtype=np.int64),
                "wave": rng.integers(0, 1000, (n, 32)).astype(np.int64)}, (
                    "timestamp", "record_id")
    if case == "presorted":
        n = 8 * 64
        return {"timestamp": np.arange(n, dtype=np.int64) * 1000,
                "record_id": np.arange(n, dtype=np.int64)}, ("timestamp", "record_id")
    raise KeyError(case)


@pytest.mark.parametrize("case", ["random", "duplicates", "time_ties_only", "non_multiple",
                                  "segments", "payload", "presorted", "one_shard"])
def test_sharded_time_sort_matches_jax(meshes, case):
    """The port's sort = JAX's bit for bit = the host lexsort."""
    mesh, jm = meshes
    rng = np.random.default_rng(len(case))
    if case == "one_shard":
        mesh, jm = tmesh.make_mesh(devices=CPU8[:1]), jmesh.make_mesh(1)
        cols, keys = _sort_case("non_multiple", rng)
    else:
        cols, keys = _sort_case(case, rng)
    got = tsort.sharded_time_sort(cols, keys, mesh)
    ref = jsort.sharded_time_sort(cols, keys, jm)
    order = np.lexsort(tuple(cols[k] for k in reversed(keys)))
    for k in cols:
        assert got[k].dtype == cols[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(got[k], cols[k][order], err_msg=k)


def test_sharded_time_sort_dtypes_and_empty(meshes):
    """Unsigned keys and payloads keep their values and dtypes; no rows
    come back as they went in; a column that is no number raises."""
    mesh, _ = meshes
    rng = np.random.default_rng(3)
    n = 8 * 20 + 5
    cols = {"timestamp": rng.integers(0, 50, n).astype(np.int64),
            "board": rng.integers(0, 3, n).astype(np.uint16),
            "flags": rng.integers(0, 2**32, n, dtype=np.uint32),
            "valid": rng.random(n) > 0.5}
    got = tsort.sharded_time_sort(cols, ("timestamp", "board"), mesh)
    order = np.lexsort((cols["board"], cols["timestamp"]))
    for k in cols:
        assert got[k].dtype == cols[k].dtype
        np.testing.assert_array_equal(got[k], cols[k][order], err_msg=k)
    empty = tsort.sharded_time_sort({"timestamp": np.zeros(0, np.int64)}, ("timestamp",), mesh)
    assert len(empty["timestamp"]) == 0
    with pytest.raises(TypeError, match="not numeric"):
        tsort.sharded_time_sort({"timestamp": np.arange(8), "s": np.array(["a"] * 8)},
                                ("timestamp",), mesh)


def test_make_sharded_time_sort_keeps_shards(meshes):
    mesh, _ = meshes
    rng = np.random.default_rng(5)
    ts = rng.integers(0, 100, 64).astype(np.int64)
    out = tsort.make_sharded_time_sort(mesh, ("timestamp",))({"timestamp": torch.from_numpy(ts)})
    assert isinstance(out["timestamp"], tmesh.ShardedTensor)
    assert [len(s) for s in out["timestamp"].shards] == [8] * 8
    np.testing.assert_array_equal(np.asarray(out["timestamp"]), np.sort(ts, kind="stable"))


# ---------------------------------------------------------------------------
# the sharded chains
# ---------------------------------------------------------------------------


def _chain_batch(n=64, L=64, seed=0):
    """Mixed-polarity narrow and wide pulses (one event in five empty),
    ragged lengths, per-event baselines, polarity codes -1/0/+1."""
    rng = np.random.default_rng(seed)
    t = np.arange(L)
    c = rng.integers(15, L - 15, n)
    width = np.where(np.arange(n) % 2 == 0, 1.5, 6.0)
    amp = rng.choice([300.0, -280.0], n) * (np.arange(n) % 5 != 0)
    waves = 1000 + amp[:, None] * np.exp(-((t - c[:, None]) ** 2) / (2 * width[:, None] ** 2))
    waves += rng.normal(0, 3, (n, L))
    return (np.round(waves).astype(np.int16), rng.integers(L // 2, L + 1, n).astype(np.int32),
            (1000 + rng.integers(-3, 4, n)).astype(np.float32),
            rng.choice(np.array([-1, 0, 1], np.int8), n))


CHAIN_FIELDS = dict(use_derivative=False, peak_height=60.0, peak_prominence=30.0,
                    peak_width=1.5, max_peaks=4, max_hits=4, s1_width_max=6.0,
                    s2_width_min=10.0)


def _same_chain(got, ref, tag):
    assert set(got) == set(ref), tag
    for k, r in ref.items():
        g = np.asarray(got[k])
        r = np.asarray(r)
        assert g.shape == r.shape, f"{tag}.{k}"
        if k == "total_area":
            np.testing.assert_allclose(g, r, rtol=RTOL, err_msg=f"{tag}.{k}")
        elif r.dtype.kind == "f":
            np.testing.assert_allclose(g, r, atol=ATOL, rtol=RTOL, err_msg=f"{tag}.{k}")
        else:
            np.testing.assert_array_equal(g, r, err_msg=f"{tag}.{k}")


def test_sharded_chains_match_jax(meshes):
    """The three sharded chains on 8 CPU shards = JAX's make_sharded_chain,
    make_sharded_chain_scan and make_sharded_chain_pallas (interpret) on 8
    virtual devices; per-event outputs are ShardedTensors, the statistics
    are summed; on the CPU no kernel launches."""
    from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc
    from waveformanalysis_tpu_torch.ops import chain_tile_cuda as ctc

    mesh, jm = meshes
    batch = _chain_batch()
    jcfg = jfc.ChainConfig(**CHAIN_FIELDS)
    tcfg = wa.ChainConfig(**CHAIN_FIELDS)
    refs = {
        "plain": jfc.make_sharded_chain(jm, jcfg),
        "scan": jax_chain_scan(jm, jcfg, interpret=True),
        "tile": make_sharded_chain_pallas(jm, jcfg, interpret=True),
    }
    steps = {"plain": wa.make_sharded_chain(mesh, tcfg),
             "scan": wa.make_sharded_chain_scan(mesh, tcfg),
             "tile": wa.make_sharded_chain_tile(mesh, tcfg)}
    launches = (csc.chain_scan_cuda.launches, ctc.chain_tile_cuda.launches)
    tbatch = wa.batch_from_numpy(*batch, device="cpu")
    one = wa.full_chain_step(*tbatch, tcfg)
    for name, step in steps.items():
        got = step(*tbatch)
        ref = jax.device_get(refs[name](*batch))
        _same_chain(got, ref, name)
        assert isinstance(got["label"], tmesh.ShardedTensor) and len(got["label"].shards) == 8
        assert got["n_s1"].dtype == torch.int32 and got["total_area"].dtype == torch.float32
        for k in jfc.CHAIN_OUT_KEYS:  # = the one-device chain bit for bit
            np.testing.assert_array_equal(np.asarray(got[k]), one[k].numpy(), err_msg=k)
        labels = np.asarray(got["label"])
        assert int(got["n_s1"]) == int(np.sum(labels == 1)) > 0
        assert int(got["n_s2"]) == int(np.sum(labels == 2)) > 0
        assert (int(got["n_peak_overflow"]), int(got["n_hit_overflow"])) == (
            int(one["n_peak_overflow"]), int(one["n_hit_overflow"]))
    assert (csc.chain_scan_cuda.launches, ctc.chain_tile_cuda.launches) == launches


def test_sharded_chain_needs_a_shard_multiple(meshes):
    mesh, _ = meshes
    batch = wa.batch_from_numpy(*_chain_batch(n=60), device="cpu")
    for make in (wa.make_sharded_chain, wa.make_sharded_chain_scan, wa.make_sharded_chain_tile):
        with pytest.raises(ValueError, match="not a multiple of the 8 shards"):
            make(mesh)(*batch)
