"""The event layer of the reference (``plain/events.py``, loops written from
the tables' definitions) against the program's host event ops, on random
hits with equal times, merges of several hits, clusters across records and
events wider than the pairing window: the two ways of computing agree. The
benchmark's runs hold the program to the reference; this test holds the
reference to the program where the cell's own data never goes."""

import numpy as np
import pandas as pd
import pytest

from portbench.reference import Tally
from portbench.reference.plain import events


def threshold_hits(rng, n):
    """Threshold-hit columns of ``n`` hits on 3 channels of 2 boards, a few
    records of 64 samples each, with repeated timestamps and heights."""
    record = rng.integers(0, max(n // 3, 1), n)
    pos = rng.integers(0, 64, n).astype(np.int64)
    start = np.maximum(pos - rng.integers(0, 6, n), 0).astype(np.int32)
    end = np.minimum(pos + rng.integers(1, 6, n), 64).astype(np.int32)
    dt = rng.choice(np.array([2, 2, 2, 4], np.int32), n)
    ts = record.astype(np.int64) * 40_000 + pos * dt * 1000
    return {"position": pos,
            "height": rng.choice(np.array([5.0, 7.5, 9.0], np.float32), n),
            "integral": rng.random(n).astype(np.float32) * 100,
            "edge_start": start, "edge_end": end,
            "width": (end - start).astype(np.float32), "dt": dt,
            "rise_time": rng.random(n).astype(np.float32),
            "fall_time": rng.random(n).astype(np.float32),
            "timestamp": ts, "board": rng.integers(0, 2, n).astype(np.int16),
            "channel": rng.integers(0, 3, n).astype(np.int16),
            "record_id": record.astype(np.int64)}


def assert_same(ref, got):
    tally = Tally()
    if isinstance(ref, dict):
        tally.columns(ref, got, "t")
    else:
        tally.frame(ref, got, "t")
    found = tally.result()
    assert found["structure"][0] == 0 and found["exact_cells"][0] == 0, found
    assert found["f32_gap"][0] <= 1e-6, found


@pytest.mark.parametrize("gap_ns,width_ns", [(0.0, 1e4), (4.0, 1e4), (30.0, 40.0)])
@pytest.mark.parametrize("seed", [1, 2])
def test_merge_and_grouping_agree_with_the_program(seed, gap_ns, width_ns):
    from waveformanalysis_tpu_torch.ops import grouping, hit_merge

    hits = threshold_hits(np.random.default_rng(seed), 400)
    merged, pairs = events.merge_hits(hits, gap_ns, width_ns)
    p_merged, _clusters, p_pairs = hit_merge.merge_hits(hits, merge_gap_ns=gap_ns,
                                                        max_total_width_ns=width_ns)
    assert_same(p_merged, merged)
    np.testing.assert_array_equal(pairs, p_pairs)
    if gap_ns:
        assert (merged["component_count"] > 1).any()
    for window in (0.0, 20.0, 100.0):
        ours = events.hit_grouped(merged, window, pairs, hits)
        theirs = grouping.group_hit_windows(
            p_merged, window, component_rows={"merged_index": p_pairs[:, 0],
                                              "hit_index": p_pairs[:, 1]},
            component_hits=hits)
        assert_same(theirs, ours)


@pytest.mark.parametrize("seed", [3, 4])
def test_events_and_pairs_agree_with_the_program(seed):
    from waveformanalysis_tpu_torch.ops import grouping

    rng = np.random.default_rng(seed)
    n = 600
    # distinct times: the order of rows of one time is not defined for df_events
    df = pd.DataFrame({"timestamp": (rng.choice(60_000, n, replace=False) * 1000).astype(np.int64),
                       "board": np.zeros(n, np.int16),
                       "channel": rng.integers(6, 8, n).astype(np.int16),
                       "height": rng.random(n).astype(np.float32),
                       "area": rng.random(n).astype(np.float32)})
    df = df.sample(frac=1.0, random_state=seed).reset_index(drop=True)
    for window in (50.0, 100.0, 400.0):
        ours = events.df_events(df, window)
        theirs = grouping.group_multi_channel_hits(df, window)
        assert_same(theirs, ours)
        for pair_window in (30.0, 100.0):
            assert_same(grouping.pair_events(theirs, pair_window, n_channels=2, start_channel=6),
                        events.df_paired(ours, pair_window, 2, 6))
