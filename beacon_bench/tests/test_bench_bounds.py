"""The roofline bound on launches counted by hand."""

import pytest
import torch

from beacon_bench.lib import bounds


def test_bound_of_picks_the_larger():
    t, by = bounds.bound_of(3.35e12, 0)
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = bounds.bound_of(0, bounds.INT32_OPS_PER_S * 2)
    assert t == pytest.approx(2.0) and by == "operations"
    assert bounds.INT32_OPS_PER_S == pytest.approx(16.7e12, rel=0.01)


def test_scatter_match_launch_counted_by_hand():
    """One slot, tile 0 of 256 lanes, a window of lanes 3..19 (17 lanes
    in three 8-lane sectors): 3 sectors x 6 packed rows x 32 B, and the
    slot's input (4 + 32 B) and output (32 B + 16 mask words of 4 B)
    once."""
    from sbeacon_tpu_torch.ops.query_pack import Q_HI, Q_LO

    T, C, cap = 256, 1, 2048
    ids = torch.zeros(1, dtype=torch.int32)
    q8 = torch.zeros((1, 8), dtype=torch.int32)
    q8[0, Q_LO], q8[0, Q_HI] = 3, 20
    rec = {"ids": ids, "q8": q8, "T": T, "C": C, "cap": cap}
    nbytes, ops = bounds.scatter_match_need(rec)
    assert nbytes == 3 * 6 * 32 + (4 + 32) + (32 + 16 * 4)
    assert ops == 17 * bounds.MATCH_OPS_PER_LANE
    # the cap cuts the window: lanes 3..10, one sector less
    nbytes2, ops2 = bounds.scatter_match_need(dict(rec, cap=8))
    assert nbytes2 == nbytes - 6 * 32 and ops2 == 8 * 40


def test_bisect_launch_counted_by_hand():
    """One query over a 100-row segment of positions 10, 20, ..., 1000
    whose start bracket [205, 400] holds rows 20..39 (positions 210 to
    400): 20 valid lanes; an any-base ALT with no REF reads REC_END,
    ALT_LEN, REC_ID and FLAGS over rows 20..39 (sectors 2..4 of each
    column, 4 x 3), two searches of 7 steps each (100 rows: 7 bits),
    the packed query once and its output row (record cap + aggregates)
    once."""
    from sbeacon_tpu_torch.ops import kernel as tk

    n = 100
    cols = torch.zeros((11, n), dtype=torch.int32)
    cols[tk.C_POS] = torch.arange(1, n + 1, dtype=torch.int32) * 10
    offsets = torch.zeros((1, 27), dtype=torch.int32)
    offsets[0, 1:] = n  # every row on chromosome code 0
    q = torch.zeros((1, tk.N_QFIELDS), dtype=torch.int32)
    q[0, tk.QF_CHROM] = 0
    q[0, tk.QF_START_MIN], q[0, tk.QF_START_MAX] = 205, 400
    q[0, tk.QF_ALT_MODE] = tk.MODE_ANY_BASE
    q[0, tk.QF_REF_WILD] = 1
    rec = {"columns": cols, "offsets": offsets, "q": q, "W": 2048,
           "R": 64}
    nbytes, ops = bounds.bisect_need(rec)
    probes = 2 * 7
    io = tk.N_QFIELDS * 4 + (64 + tk.N_AGG) * 4
    assert nbytes == (4 * 3 + probes) * 32 + io
    assert ops == 20 * bounds.BISECT_OPS_PER_LANE + probes * 4
    # the window cap keeps the first 8 lanes: rows 20..27, one sector
    # (rows 16..23) and part of the next (24..31): 2 a column
    nbytes2, ops2 = bounds.bisect_need(dict(rec, W=8))
    assert nbytes2 == (4 * 2 + probes) * 32 + io
    assert ops2 == 8 * bounds.BISECT_OPS_PER_LANE + probes * 4


def test_search_finds_the_bracket():
    pos = torch.tensor([1, 3, 3, 5, 7, 9, 9, 9, 11], dtype=torch.int32)
    lo = torch.tensor([0, 0, 4], dtype=torch.long)
    hi = torch.tensor([9, 9, 9], dtype=torch.long)
    key = torch.tensor([3, 9, 0], dtype=torch.long)
    assert bounds._search(pos, key, lo, hi, upper=False).tolist() == [1, 5, 4]
    assert bounds._search(pos, key, lo, hi, upper=True).tolist() == [3, 8, 4]
