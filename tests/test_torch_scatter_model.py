"""The scatter match kernel's window body (``csrc/scatter_match.cu``,
J1) as the card runs it, held against the twin and JAX.

J1 reads only the window's valid lanes (one lane a thread straight into
registers up to 1024 lanes; beyond, bulk copies of the 16-byte-aligned
part of each tile row that covers them into shared memory, which the
model follows), skips slots with no valid lane, and decides each
record's first matched lane from two warp ballots per
32-lane group (the match and SAME_PREV over the valid lanes) with a
carry for a chain that enters a group at its lane 0, read back over the
earlier groups' ballots. The mask words are the halves of the match
ballots. A numpy model of those steps, reading AN and flags only from
the copied lanes, must equal ``scatter_core_reference`` and JAX's
``_scatter_core`` in both first-match forms (K-shift and segmented
scan): under hypothesis, on tiles whose SAME_PREV chains cross 32-lane
groups and tiles, and in named cases (a window starting mid-record,
empty windows and pad slots, ``ROW_CLAMPED``, copy edges at every
16-byte offset, tile ids clamped at both ends). The lane predicate is
the twin's (``_scatter_core_parts``): J1's is a copy of J2's
(``csrc/scatter_core.cuh``), held against the twin on the card.

The kernel itself is held against the twin on the card
(tests/test_torch_cuda.py, chip_smoke.py). Every value is an integer:
the tolerance is 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sbeacon_tpu.ops import scatter_kernel as jsk
from sbeacon_tpu_torch.ops import query_pack as qp
from sbeacon_tpu_torch.ops import scatter_kernel as tsk

T = 128
ROWS = 7  # packed rows 1-7 of a tile reach shared memory (pos is not read)
GROUP = 32  # lanes of one warp ballot
SENTINEL = np.int64(0x7EADBEEF)  # a shared word no copy wrote
SETTINGS = settings(max_examples=150, deadline=None, database=None,
                    derandomize=True)
TIERS = [(1, T), (2, T), (5, 4 * T), (17, 16 * T)]
N_TILES = 24  # every case's index: one shape, so each program compiles once
N_SLOTS = 32  # slots a call, pad slots filling the rest
SEG_K = 80  # the K-shift form's K, above every chain drawn here (70 rows)
_JAX_CORE = jax.jit(jsk._scatter_core,
                    static_argnames=("T", "CAP", "C", "exact_only", "seg_k"))


def _wrap(x):
    """int64 -> int32 with wraparound."""
    return ((np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31).astype(np.int64)


def _copy_range(lo, hi, tile0, cap, span):
    """The kernel's valid lanes [a, b) of one slot (int32 lo + cap and
    the window end as the card computes them), all of the span when
    tile0 * T + span could wrap int32."""
    win_end = min(hi, int(_wrap(lo + cap)))
    g0 = tile0 * T
    if g0 < -(2**31) or g0 + span - 1 > 2**31 - 1:
        return 0, span, win_end
    a = min(max(lo - g0, 0), span)
    b = min(max(win_end - g0, a), span)
    return a, b, win_end


def j1_model(tiles, tile_ids, q8, m_i, *, C, cap):
    """(agg [B, 8], masks [B, C*T/16]) as J1 computes them, int64 numpy.
    ``m_i`` [B, C*T] is the predicate per lane (the twin's)."""
    n_tiles = tiles.shape[0]
    span = C * T
    groups = span // GROUP
    B = len(tile_ids)
    agg = np.zeros((B, 8), np.int64)
    masks = np.zeros((B, span // 16), np.int64)
    for q in range(B):
        lo, hi = int(q8[q, qp.Q_LO]), int(q8[q, qp.Q_HI])
        tile0 = int(tile_ids[q])
        wide = int(_wrap(hi - lo)) > cap
        a, b, win_end = _copy_range(lo, hi, tile0, cap, span)
        agg[q, 5] = int(wide)
        if a >= b:  # no valid lane: no copy, zero mask words
            continue
        # the bulk copies: rows 1-7 of tiles a // T .. (b - 1) // T over
        # the 16-byte chunks that cover [a, b)
        smem = np.full((C, ROWS + 1, T), SENTINEL)
        for c in range(a // T, (b - 1) // T + 1):
            t0 = max(a - c * T, 0) & ~3
            t1 = (min(b - c * T, T) + 3) & ~3
            tile = min(max(tile0 + c, 0), n_tiles - 1)
            smem[c, 1:, t0:t1] = tiles[tile, 1:, t0:t1]
        col = lambda r, l: smem[l // T, r, l % T]

        lanes = np.arange(span)
        gidx = _wrap(tile0 * T + lanes)
        valid = (gidx >= lo) & (gidx < win_end)
        assert ((lanes >= a) & (lanes < b) >= valid).all()
        m = m_i[q].astype(bool)
        assert not (m & ~valid).any()
        flags = np.array([col(tsk.P_FLAGS, l) if v else 0
                          for l, v in enumerate(valid)])
        assert not (flags == SENTINEL).any()
        same = valid & ((flags & tsk.SAME_PREV) != 0)
        clamped = int((valid & ((flags & tsk.ROW_CLAMPED) != 0)).sum())

        # the ballots of each 32-lane group, and the mask words
        mb = [int(sum(int(m[g * GROUP + i]) << i for i in range(GROUP)))
              for g in range(groups)]
        sb = [int(sum(int(same[g * GROUP + i]) << i for i in range(GROUP)))
              for g in range(groups)]
        for g in range(groups):
            masks[q, 2 * g] = mb[g] & 0xFFFF
            masks[q, 2 * g + 1] = mb[g] >> 16

        # the first-match rule from the ballots
        full = (1 << GROUP) - 1
        all_alleles = 0
        for g in range(groups):
            if mb[g] == 0:
                continue
            starts = ~sb[g] & full
            carry = False
            if not starts & 1:
                for h in range(g - 1, -1, -1):
                    sh = ~sb[h] & full
                    if sh:
                        carry = (mb[h] >> (sh.bit_length() - 1)) != 0
                        break
                    if mb[h]:
                        carry = True
                        break
            for i in range(GROUP):
                if not (mb[g] >> i) & 1:
                    continue
                before = (1 << i) - 1
                own = starts & (before | (1 << i))
                if own:
                    s = own.bit_length() - 1
                    first = (mb[g] & before & ~((1 << s) - 1)) == 0
                else:
                    first = (mb[g] & before) == 0 and not carry
                if first:
                    an = col(tsk.P_AN, g * GROUP + i)
                    assert an != SENTINEL
                    all_alleles += int(an)
        ac = np.array([col(tsk.P_AC, l) if v else 0
                       for l, v in enumerate(m)])
        assert not (ac == SENTINEL).any()
        call_count = int(_wrap(ac[m].sum()))
        agg[q] = [int(call_count > 0), call_count, int((ac[m] != 0).sum()),
                  int(_wrap(all_alleles)), int(m.sum()),
                  int(wide or clamped > 0), 0, 0]
    return agg, masks


def _check(tiles_np, ids_np, q8_np, *, C, cap, with_jax=True):
    """The model against the twin and (``with_jax``) JAX in both
    first-match forms, the slots padded to a multiple of N_SLOTS with pad
    slots. Returns the model's agg of the given slots."""
    n = len(ids_np)
    pad = -n % N_SLOTS
    ids_np = np.concatenate([ids_np, np.zeros(pad, np.int32)])
    q8_np = np.concatenate([q8_np, np.zeros((pad, 8), np.int32)])
    tiles = torch.from_numpy(tiles_np)
    ids = torch.from_numpy(ids_np)
    q8 = torch.from_numpy(q8_np)
    flags = tiles_np[:, tsk.P_FLAGS, :].reshape(-1)
    same = np.concatenate(([0], (flags & tsk.SAME_PREV) != 0, [0]))
    assert int(np.diff(np.flatnonzero(same == 0)).max()) - 1 <= SEG_K
    _agg, _masks, m_i, _win, _gidx = tsk._scatter_core_parts(
        tiles, ids, q8, T=T, CAP=cap, C=C, seg_k=None)
    agg, masks = j1_model(tiles_np, ids_np, q8_np, m_i.numpy(), C=C, cap=cap)
    for k in (SEG_K, None):
        want_agg, want_masks = tsk.scatter_core_reference(
            tiles, ids, q8, T=T, CAP=cap, C=C, seg_k=k)
        np.testing.assert_array_equal(agg, want_agg.numpy())
        np.testing.assert_array_equal(masks, want_masks.numpy())
        if not with_jax:
            continue
        j_agg, j_masks, *_ = _JAX_CORE(
            jnp.asarray(tiles_np), jnp.asarray(ids_np), jnp.asarray(q8_np),
            T=T, CAP=cap, C=C, seg_k=k)
        np.testing.assert_array_equal(agg, np.asarray(j_agg))
        np.testing.assert_array_equal(masks, np.asarray(j_masks))
    return agg[:n]


def _tiles(rng, n_tiles, rec_lens, p_clamped=0.0, extreme=False):
    """int32 [n_tiles, 8, T] packed tiles: records of the given row counts
    back to back (SAME_PREV on every row but a record's first), random
    hashes and lengths from small sets (so predicates hit), flags with
    the single-base and symbolic bits, AC and AN near the int32 ends when
    ``extreme``."""
    n = n_tiles * T
    same = np.zeros(n, np.int64)
    row = 0
    for k in rec_lens:
        same[row + 1:row + k] = 1
        row += k
        if row >= n:
            break
    lim = 2**31 - 1 if extreme else 100
    packed = np.zeros((8, n), np.int64)
    packed[tsk.P_POS] = np.arange(n)
    packed[tsk.P_REC_END] = rng.integers(0, 50, n)
    packed[tsk.P_REF_HASH] = rng.integers(0, 3, n)
    packed[tsk.P_ALT_HASH] = rng.integers(0, 3, n)
    packed[tsk.P_LENS] = rng.integers(1, 4, n) | (rng.integers(1, 4, n) << 16)
    flags = (rng.random(n) < 0.5) * 256 | (rng.random(n) < 0.2) * 1
    flags |= rng.integers(0, 4, n) << 19  # repeat_k + 1
    flags |= same * tsk.SAME_PREV
    flags |= (rng.random(n) < p_clamped) * tsk.ROW_CLAMPED
    packed[tsk.P_FLAGS] = flags
    packed[tsk.P_AC] = rng.integers(-lim if extreme else 0, lim, n)
    packed[tsk.P_AN] = rng.integers(-lim if extreme else 0, lim, n)
    return np.ascontiguousarray(
        packed.astype(np.int32).reshape(8, n_tiles, T).transpose(1, 0, 2))


def _q8(rng, lo, hi, mode):
    """A packed query: wildcard ref, end bracket [0, 40], alt mode
    ``mode`` (0 exact: hash 1 and length 2; 1 any single base; 2 a
    variant type drawn from the five)."""
    meta = 1 | (mode << 1) | (int(rng.integers(0, 5)) << 3)
    lens = 2 | (0xFFFF << 16)
    return [lo, hi, 0, 40, 0, 1, meta, lens]


def _slots(rng, specs):
    """(tile_ids, q8) int32 of slots given as (lo, hi, mode, tile0 or
    None for lo // T)."""
    ids, q8 = [], []
    for lo, hi, mode, tile0 in specs:
        ids.append(lo // T if tile0 is None else tile0)
        q8.append(_q8(rng, lo, hi, mode) if mode is not None else [0] * 8)
    return np.array(ids, np.int32), np.array(q8, np.int64).astype(np.int32)


@st.composite
def _cases(draw):
    C, cap = draw(st.sampled_from(TIERS))
    seed = draw(st.integers(0, 2**31))
    rec_lens = draw(st.lists(st.one_of(st.integers(1, 3),
                                       st.integers(30, 70)),
                             min_size=1, max_size=200))
    n_rows = (C + 6) * T  # windows start in the first C + 6 tiles
    slots = []
    for _ in range(draw(st.integers(1, 6))):
        lo = draw(st.integers(0, n_rows - 1))
        hi = lo + draw(st.integers(-3, cap + 64))
        mode = draw(st.sampled_from([0, 1, 2, None]))  # None: a pad slot
        slots.append((lo, hi, mode, None) if mode is not None
                     else (0, 0, None, 0))
    return C, cap, seed, rec_lens, slots, draw(st.booleans())


@SETTINGS
@given(_cases())
def test_model_equals_twin_and_jax(case):
    """Random chains (records of 1-3 and 30-70 rows, across 32-lane
    groups and tiles), windows anywhere (mid-record starts, empty and
    wide windows), pad slots, AC and AN near both int32 ends."""
    C, cap, seed, rec_lens, slots, extreme = case
    rng = np.random.default_rng(seed)
    tiles = _tiles(rng, N_TILES, rec_lens, p_clamped=0.002, extreme=extreme)
    ids, q8 = _slots(rng, slots)
    _check(tiles, ids, q8, C=C, cap=cap)


@pytest.mark.parametrize("C,cap", TIERS)
def test_window_starting_mid_record(C, cap):
    """Windows that start inside a 45-row record which began in the tile
    before, or in the same tile, or at its first row: the lanes before lo
    never match, so each record's first matched lane counts its AN once."""
    rng = np.random.default_rng(C)
    tiles = _tiles(rng, N_TILES, [45] * 40)
    specs = []
    for rec in range(2, 12):
        first = rec * 45
        for off in (0, 1, 13, 31, 32, 33, 44):
            specs.append((first + off, first + off + cap // 2 + 7, 1, None))
    ids, q8 = _slots(rng, specs)
    agg = _check(tiles, ids, q8, C=C, cap=cap)
    assert (agg[:, 3] != 0).any()


@pytest.mark.parametrize("C,cap", TIERS)
def test_empty_windows_and_pad_slots(C, cap):
    """Slots with hi <= lo (and int32-wrapping hi - lo), and pad slots as
    _launch_tier makes them (q8 all zeros, tile 0): zero aggregates but
    the overflow bit, zero mask words."""
    rng = np.random.default_rng(3)
    tiles = _tiles(rng, N_TILES, [1, 2, 40] * 30)
    specs = [(0, 0, None, 0), (100, 100, 1, None), (100, 99, 0, None),
             (300, 5, 2, None), (0, 0, 1, None)]
    ids, q8 = _slots(rng, specs)
    q8 = np.concatenate([q8, [[2**31 - 10, -(2**31) + 5000, 0, 40, 0, 1, 3,
                               2 | (0xFFFF << 16)]]]).astype(np.int32)
    ids = np.concatenate([ids, [0]]).astype(np.int32)
    agg = _check(tiles, ids, q8, C=C, cap=cap)
    assert not agg[:, :5].any()
    assert agg[-1, 5] == 1  # hi - lo wraps to a positive width


@pytest.mark.parametrize("C,cap", TIERS)
def test_row_clamped_in_and_out_of_the_window(C, cap):
    """A ROW_CLAMPED row overflows the slots whose valid lanes hold it,
    and only those; its lanes in the copy's 16-byte margin do not."""
    rng = np.random.default_rng(4)
    tiles = _tiles(rng, N_TILES, [1, 3, 35] * 40)
    r = T + 50
    tiles[r // T, tsk.P_FLAGS, r % T] |= tsk.ROW_CLAMPED
    specs = [(r, r + 1, 1, None), (r + 1, r + 9, 1, None),
             (r - 2, r, 1, None), (r - 40, r + 40, 0, None)]
    ids, q8 = _slots(rng, specs)
    agg = _check(tiles, ids, q8, C=C, cap=cap)
    assert agg[:, 5].tolist() == [1, 0, 0, 1]


@pytest.mark.parametrize("C,cap", TIERS)
def test_copy_edges_at_every_16_byte_offset(C, cap):
    """Windows whose first and last valid lanes fall at each offset of a
    16-byte chunk (4 lanes), at tile edges too: every lane the model
    reads lies in the copy, and the margin lanes stay invalid."""
    rng = np.random.default_rng(5)
    tiles = _tiles(rng, N_TILES, [2, 33, 1] * 60)
    specs = []
    for base in (T - 4, T, 2 * T - 3):
        for d0 in range(4):
            for w in (1, 2, 3, 4, 5, 127, 129, cap):
                specs.append((base + d0, base + d0 + w, 1, None))
    ids, q8 = _slots(rng, specs)
    _check(tiles, ids, q8, C=C, cap=cap)


@pytest.mark.parametrize("C,cap", TIERS)
def test_tile_ids_clamped_at_both_ends(C, cap):
    """Tile ids past the index's last tile gather the last tile, as an XLA
    gather clamps; the windows stay where gidx puts them. Below 0 the
    twin and the kernel clamp to tile 0, where a JAX index array would
    wrap a negative id as NumPy does: no slot has one (tile ids are
    lo // T of a row), so those are held against the twin alone."""
    rng = np.random.default_rng(6)
    tiles = _tiles(rng, N_TILES, [3, 40] * 30)
    last = N_TILES - 1
    specs = [(last * T + 5, last * T + 60, 1, last),
             ((last + 2) * T + 1, (last + 2) * T + 90, 1, last + 2)]
    ids, q8 = _slots(rng, specs)
    _check(tiles, ids, q8, C=C, cap=cap)
    specs = [(-T + 3, -T + 70, 1, -1), (-3 * T, -3 * T + 9, 0, -3)]
    ids, q8 = _slots(rng, specs)
    _check(tiles, ids, q8, C=C, cap=cap, with_jax=False)
