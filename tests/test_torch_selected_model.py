"""The fused match + planes kernel's sample-hit selection
(``csrc/scatter_selected.cu``, J2), as the card runs it, held against the
twin ``scatter_selected_reference`` and JAX's ``_selected_batch``.

The kernel keeps the first R matched lanes of the window in lane order,
each with its window-local record id (the inclusive count of lanes
without SAME_PREV: ``seg``), and selects the sample-hit rows with
``plane_reduce::or_select``: the reference's four segmented scans over
the valid lanes only, rounded up to a warp, in log depth, or by one warp
over its 32 lanes when the matched lanes fit it. The numpy model of
those scans is ``test_torch_plane_scan._or_sel`` (the chunked block
scans of ``plane_reduce.cuh`` at the kernel's 128 threads, or one warp's
32 lanes, the lanes past R included when R < 32); here it reads
J2's ``seg`` ids built from SAME_PREV chains and J2's rc (AC without
counts), and must select exactly the rows whose genotype words the twin
and JAX OR together. Every plane row is one-hot (row i sets bit i), so
the sample-hit words name the selected rows.

Windows are crafted packed tiles: records of 1-12 lanes, some lanes of a
record not matching, AC near both ends of the int32 range so the sums
wrap. Every value is an integer: the tolerance is 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sbeacon_tpu.ops import scatter_kernel as jsk
from sbeacon_tpu_torch.ops import scatter_kernel as tsk
from test_torch_plane_scan import _or_sel

T = 128
THREADS = 128  # scatter_selected.cu: scatter_core.cuh kThreads
SINGLE_BASE = 256  # index.columnar FLAG.SINGLE_BASE
MODE_ANY_BASE = 1
SETTINGS = settings(max_examples=150, deadline=None, database=None,
                    derandomize=True)


def _window(records, ac, n_tiles):
    """Packed tiles [n_tiles, 8, T] whose window starts at tile 0, lane 0:
    ``records`` lists each record's lanes as match flags (its first lane
    without SAME_PREV, the rest with it); ``ac`` gives every lane's AC.
    Lanes past the records match nothing."""
    tiles = np.zeros((n_tiles, tsk.N_PACKED, T), np.int32)
    flat = tiles.transpose(1, 0, 2).reshape(tsk.N_PACKED, -1)
    l = 0
    for rec in records:
        for j, m in enumerate(rec):
            flat[tsk.P_FLAGS, l] = (SINGLE_BASE if m else 0) | (
                tsk.SAME_PREV if j else 0)
            l += 1
    flat[tsk.P_REC_END] = 100
    flat[tsk.P_LENS] = 1 | (1 << 16)
    flat[tsk.P_AC, : len(ac)] = ac
    flat[tsk.P_AN] = 7
    return np.ascontiguousarray(
        flat.reshape(tsk.N_PACKED, n_tiles, T).transpose(1, 0, 2)), l


def _q8(n_lanes):
    """A query over window lanes [0, n_lanes): any single base, any ref,
    any end, no length bound."""
    q = np.zeros((1, 8), np.int32)
    q[0, tsk.Q_LO] = 0
    q[0, tsk.Q_HI] = n_lanes
    q[0, tsk.Q_END_MAX] = 1 << 30
    q[0, tsk.Q_META] = 1 | (MODE_ANY_BASE << 1)
    q[0, tsk.Q_LENS] = np.int32(-(1 << 16))  # max_len 0xFFFF: unbounded
    return q


def _model(records, ac, R):
    """J2's selection: the first R matched lanes, their seg ids, rc = AC,
    then or_select's scans (``_or_sel``): by one warp over its 32 lanes
    when the matched lanes fit it (``warp_or_select``), else by the
    block's 128 threads over the lanes rounded up to a warp. Returns the
    selected lanes."""
    lanes, seg, n_seg, l = [], [], 0, 0
    for rec in records:
        n_seg += 1
        for m in rec:
            if m and len(lanes) < R:
                lanes.append(l)
                seg.append(n_seg)
            l += 1
    rc = [int(ac[k]) for k in lanes]
    if len(lanes) <= 32:
        sel = _or_sel(rc, seg, len(lanes), 32, 32, 32)
    else:
        sel = _or_sel(rc, seg, len(lanes), R, THREADS, 32)
    return {k for k, s in zip(lanes, sel) if s}


def _selected_rows(or_words):
    bits = np.unpackbits(or_words.view(np.uint8), bitorder="little")
    return set(np.flatnonzero(bits).tolist())


def _check(records, ac, R, C):
    cap = max(T, (C - 1) * T)
    n_tiles = C + 1
    tiles, n_lanes = _window(records, ac, n_tiles)
    assert n_lanes <= min(cap, C * T)
    n_rows = n_tiles * T
    w = n_rows // 32
    gt = np.zeros((n_rows, w), np.uint32)
    gt[np.arange(n_rows), np.arange(n_rows) // 32] = (
        np.uint32(1) << (np.arange(n_rows) % 32).astype(np.uint32))
    gt = gt.view(np.int32)
    mask = np.full((1, w), -1, np.int32)
    ids = np.zeros(1, np.int32)
    q8 = _q8(n_lanes)
    want = _model(records, ac, R)
    t = torch.from_numpy
    got = tsk.scatter_selected_reference(
        t(tiles), t(gt), t(gt), t(gt), t(gt), t(ids), t(q8), t(mask), T=T,
        CAP=cap, C=C, R=R, seg_k=None)
    j = jsk._selected_batch(
        jnp.asarray(tiles), jnp.asarray(gt), jnp.asarray(gt), jnp.asarray(gt),
        jnp.asarray(gt), jnp.asarray(ids), jnp.asarray(q8),
        jnp.asarray(mask), T=T, CAP=cap, nslots=1, C=C, R=R, seg_k=None)
    assert _selected_rows(got[4].numpy()[0]) == want
    assert _selected_rows(np.asarray(j[4])[0]) == want
    n_valid = min(sum(sum(r) for r in records), R)
    assert int((got[1] >= 0).sum()) == n_valid
    return want


def _records(rng, n_lanes, max_len=12, p_match=0.8):
    out, left = [], n_lanes
    while left > 0:
        n = min(left, int(rng.integers(1, max_len + 1)))
        out.append([bool(rng.random() < p_match) for _ in range(n)])
        left -= n
    return out


def _ac(rng, n, big):
    small = rng.integers(-3, 6, n)
    if not big:
        return small.astype(np.int32)
    ends = rng.choice([-1, 1], n) * rng.integers(2**31 - 2**20, 2**31, n)
    return np.where(rng.random(n) < 0.5, ends, small).astype(np.int32)


# R -> the tier width C whose cap ((C - 1) * T, T at C = 1) holds every
# lane of the named cases (R + 3 lanes when a record is cut at R)
TIERS = {1: 1, 31: 1, 32: 1, 33: 1, 128: 3, 1024: 10}


@pytest.mark.parametrize("case", ["n_valid_0", "n_valid_1", "n_valid_R",
                                  "cut_at_R"])
@pytest.mark.parametrize("R", sorted(TIERS))
def test_or_sel_model_named_cases(R, case):
    """R across the warp edges; no match, one match, exactly R matched
    lanes, and a record whose matched lanes straddle the R-th slot."""
    C = TIERS[R]
    rng = np.random.default_rng(R * 10 + len(case))
    if case == "n_valid_0":
        records = [[False] * 3 for _ in range(5)]
    elif case == "n_valid_1":
        records = [[False, True, False], [False]]
    elif case == "n_valid_R":
        records = [[True] * min(R - k, 5) for k in range(0, R, 5)]
    else:  # the last record runs past slot R - 1
        lanes = max(R - 2, 0)
        records = [[True] * min(lanes - k, 4) for k in range(0, lanes, 4)]
        records.append([True] * 5)
    n = sum(len(r) for r in records)
    ac = _ac(rng, n, big=R % 2 == 1)
    picked = _check(records, ac, R, C)
    n_match = sum(sum(r) for r in records)
    if case == "n_valid_0":
        assert not picked
    if case == "cut_at_R":
        assert n_match > R


@SETTINGS
@given(seed=st.integers(0, 2**31 - 1), n_lanes=st.integers(1, 160),
       big=st.booleans(), max_len=st.integers(1, 12))
def test_or_sel_model_matches_twin_and_jax(seed, n_lanes, big, max_len):
    """Hypothesis: records of 1-12 lanes over up to 160 lanes (R = 160, so
    each of the 128 threads scans up to two lanes), some lanes unmatched,
    AC near both ends of the int32 range or small and negative."""
    rng = np.random.default_rng(seed)
    records = _records(rng, n_lanes, max_len)
    _check(records, _ac(rng, n_lanes, big), 160, 3)


@SETTINGS
@given(seed=st.integers(0, 2**31 - 1), n_valid=st.integers(0, 32),
       big=st.booleans(), max_len=st.integers(1, 12),
       threads=st.sampled_from([128, 256]),
       R=st.sampled_from([32, 33, 160, 1024]))
def test_warp_or_select_equals_block_form(seed, n_valid, big, max_len,
                                          threads, R):
    """At most 32 valid lanes, ``warp_or_select`` (one warp over its 32
    lanes) selects what ``or_select``'s block form (the one J6 takes at
    every n_valid) selects at 128 and 256 threads, for any R: the two
    forms differ in their scans only."""
    rng = np.random.default_rng(seed)
    seg, n_seg = [], 0
    for rec in _records(rng, n_valid, max_len):
        n_seg += 1
        seg += [n_seg] * len(rec)
    rc = _ac(rng, n_valid, big).tolist()
    assert (_or_sel(rc, seg, n_valid, 32, 32, 32)
            == _or_sel(rc, seg, n_valid, R, threads, 32))
