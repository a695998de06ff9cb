"""The plane-stats kernel (``plane_stats_kernel`` in
``csrc/plane_stats.cu``, J4) as the card runs it, held against the twin
and JAX.

J4 sizes its grid to the card: whole groups of 8 rows (2 with the count
planes), about one group a warp, at most 2 blocks an SM, each block a
contiguous run of groups; a warp takes the groups warp, warp + 8, ... of
its block's run, reads every word of the group's rows (clamped row ids,
the last row repeated past the run's end) in rounds of 4 32-word
chunks, writes each row's four popcounts once, and ORs its selected
rows' masked gt words into the block's words. The blocks form clusters
of up to 8 (the grid rounded up to whole clusters, the extra blocks
without rows); each cluster ORs its blocks' words into its leader's;
a launch of one cluster has its leader write or_words, else each leader
stores its words to its row of a scratch buffer and the leader that
takes the last ticket folds every row into or_words; without the OR
block 0 writes zeros.

A numpy model of that partition (the grid, the runs, the groups, the
chunk rounds, the per-block words, the clusters and the fold, with the
clusters finishing in a random order) must equal
``plane_stats_reference`` and
JAX's ``_plane_stats``: planes of 1-257 words (a 40-sample plane with a
tail word among them), R from 0 past the grid's cap, clamped rows,
or_sel none, some and all, with and without counts, under hypothesis
and in named cases.

The kernel itself is held against the twin on the card
(tests/test_torch_cuda.py, chip_smoke.py). Every value is an integer:
the tolerance is 0.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sbeacon_tpu.index import build_index as j_build_index
from sbeacon_tpu.ops import plane_kernel as jpk
from sbeacon_tpu.testing import random_records as j_random_records
from sbeacon_tpu_torch.index import shard_from_reference
from sbeacon_tpu_torch.ops import plane_kernel as tpk

WARPS = 8
CHUNKS = 4  # 32-word chunks of a row a warp loads a round
BLOCKS_PER_SM = 2
CLUSTER = 8
H100_SMS = 132
DEADBEEF = 0xDEADBEEF
SETTINGS = settings(max_examples=80, deadline=None, database=None,
                    derandomize=True)


def group_rows(with_counts):
    return 2 if with_counts else 8


def grid(R, with_counts, n_sm=H100_SMS):
    """(blocks, rows of a block's run) of a launch over R rows."""
    gr = group_rows(with_counts)
    groups = -(-R // gr)
    if groups <= 0:
        return 1, 0
    g = min(-(-groups // WARPS), BLOCKS_PER_SM * n_sm)
    per = -(-groups // g)
    blocks = -(-groups // per)
    return blocks, -(-groups // blocks) * gr


def clusters(blocks):
    """(blocks a cluster, clusters) of a launch of ``blocks`` blocks with
    rows."""
    c = min(CLUSTER, blocks)
    return c, -(-blocks // c)


def plane_stats_model(gt, gt2, tok1, tok2, rows, or_sel, mask, *,
                      with_counts, with_or, n_sm=H100_SMS, seed=0):
    """(counts [R, 4] int32, or_words [W] int32) as the launch computes
    them, from uint32 numpy planes; every output word starts as
    0xDEADBEEF and must be written."""
    n_plane, W = gt.shape
    R = len(rows)
    blocks, per = grid(R, with_counts, n_sm)
    gr = group_rows(with_counts)
    c, n_clusters = clusters(blocks)
    counts = np.full((R, 4), DEADBEEF, np.uint32)
    or_words = np.full(W, DEADBEEF, np.uint32)
    scratch = np.full((n_clusters, W), DEADBEEF, np.uint32)
    words = {}  # each cluster leader's words
    planes = (gt, gt2, tok1, tok2) if with_counts else (gt,)
    for b in range(n_clusters * c):  # the blocks past ``blocks`` hold none
        r0, r1 = b * per, min(b * per + per, R)
        s_or = np.zeros(W, np.uint32)
        for warp in range(WARPS):
            for i0 in range(r0 + warp * gr, r1, WARPS * gr):
                ids = [min(i0 + j, r1 - 1) for j in range(gr)]
                rr = np.clip(rows[ids].astype(np.int64), 0, n_plane - 1)
                sel = [with_or and i0 + j < r1 and or_sel[ids[j]] != 0
                       for j in range(gr)]
                pc = np.zeros((gr, 4), np.int64)
                for w0 in range(0, W, 32 * CHUNKS):
                    for u in range(CHUNKS):
                        if w0 + 32 * u >= W:
                            break
                        w = np.arange(w0 + 32 * u, min(w0 + 32 * u + 32, W))
                        m = mask[w]
                        for k, plane in enumerate(planes):
                            pc[:, k] += np.bitwise_count(
                                plane[rr][:, w] & m).sum(axis=1,
                                                         dtype=np.int64)
                        gm = gt[rr][:, w] & m
                        for j in range(gr):
                            if sel[j]:
                                s_or[w] |= gm[j]
                for j in range(gr):
                    if i0 + j < r1:
                        assert counts[i0 + j, 0] == DEADBEEF  # written once
                        counts[i0 + j] = pc[j]
        if with_or:  # into the cluster leader's words
            lead = words.setdefault(b // c, np.zeros(W, np.uint32))
            lead |= s_or
    if not with_or:
        or_words[:] = 0  # block 0
    elif n_clusters == 1:
        or_words[:] = words[0]
    else:
        for k, w in words.items():
            scratch[k] = w
        order = list(range(n_clusters))
        random.Random(seed).shuffle(order)
        last = order[-1]  # the leader that takes the last ticket
        assert not (scratch == DEADBEEF).all(axis=1).any() or W == 0
        or_words[:] = np.bitwise_or.reduce(scratch, axis=0) | words[last]
    assert not (counts == DEADBEEF).all(axis=1).any()
    return (counts.view(np.int32), or_words.view(np.int32))


def _planes(rng, n_plane, W, with_counts):
    g = rng.integers(0, 2**32, (4 if with_counts else 1, n_plane, W),
                     dtype=np.uint32)
    g &= rng.integers(0, 2**32, g.shape, dtype=np.uint32)  # sparser bits
    return [g[0]] * 4 if not with_counts else list(g)


def _twin(planes, rows, or_sel, mask, **kw):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    counts, ow = tpk.plane_stats_reference(
        *(t(p) for p in planes), torch.from_numpy(rows.astype(np.int32)),
        torch.from_numpy(or_sel.astype(np.int32)), t(mask), **kw)
    return counts.numpy(), ow.numpy()


@st.composite
def _cases(draw):
    seed = draw(st.integers(0, 2**20))
    W = draw(st.sampled_from([1, 2, 3, 31, 79, 128, 129, 257]))
    R = draw(st.sampled_from([0, 1, 2, 7, 8, 9, 15, 17, 63, 64, 65, 257,
                              1000, 2053]))
    n_sm = draw(st.sampled_from([1, 2, 5, 132]))
    with_counts = draw(st.booleans())
    sel = draw(st.sampled_from(["none", "some", "all"]))
    return seed, W, R, n_sm, with_counts, sel


@SETTINGS
@given(_cases())
def test_model_equals_twin(case):
    """Planes of 1-257 words, R from 0 past the grid's cap (small cards
    give several groups a warp), clamped rows, every or_sel kind."""
    seed, W, R, n_sm, with_counts, sel = case
    rng = np.random.default_rng(seed)
    n_plane = 97
    planes = _planes(rng, n_plane, W, with_counts)
    rows = rng.integers(-3, n_plane + 3, R)
    or_sel = {"none": np.zeros(R, np.int64), "all": np.ones(R, np.int64),
              "some": (rng.random(R) < 0.2).astype(np.int64)}[sel]
    mask = rng.integers(0, 2**32, W, dtype=np.uint32)
    kw = dict(with_counts=with_counts, with_or=sel != "none")
    got = plane_stats_model(*planes, rows, or_sel, mask, n_sm=n_sm,
                            seed=seed, **kw)
    want = _twin(planes, rows, or_sel, mask, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_grid_at_the_serving_shapes():
    """Blocks, run lengths and clusters on the H100: phase 14's median
    row set (7097 rows) without counts is 111 blocks of 64 rows, one
    group a warp, in 14 clusters; with counts 254 blocks of 28 rows in
    32; past the cap (2 blocks an SM) warps take several groups; no
    rows is one block."""
    assert grid(7097, False) == (111, 64)
    assert grid(7097, True) == (254, 28)
    assert grid(70001, False) == (258, 272)
    assert grid(1, False) == (1, 8) and grid(0, True) == (1, 0)
    assert grid(9, False) == (1, 16) and grid(65, False) == (2, 40)
    assert clusters(111) == (8, 14) and clusters(254) == (8, 32)
    assert clusters(5) == (5, 1) and clusters(9) == (8, 2)


@pytest.mark.parametrize("with_counts", [True, False])
def test_runs_cover_every_row_once(with_counts):
    """The blocks' runs and the warps' groups cover rows [0, R) exactly
    once, with no empty block, for every R up to 3000 and past the cap
    on small cards."""
    gr = group_rows(with_counts)
    for n_sm in (1, 3, 132):
        for R in list(range(0, 400)) + [999, 1000, 2047, 2999]:
            blocks, per = grid(R, with_counts, n_sm)
            assert blocks <= max(1, BLOCKS_PER_SM * n_sm)
            seen = []
            for b in range(blocks):
                r0, r1 = b * per, min(b * per + per, R)
                assert r1 > r0 or R == 0
                for warp in range(WARPS):
                    for i0 in range(r0 + warp * gr, r1, WARPS * gr):
                        seen += [i for i in range(i0, i0 + gr) if i < r1]
            assert sorted(seen) == list(range(R))


def test_without_or_the_words_are_zero():
    rng = np.random.default_rng(4)
    planes = _planes(rng, 50, 79, False)
    rows = rng.integers(0, 50, 3000)
    ones = np.ones(3000, np.int64)
    mask = np.full(79, 0xFFFFFFFF, np.uint32)
    _c, ow = plane_stats_model(*planes, rows, ones, mask, with_counts=False,
                               with_or=False)
    assert not ow.any()
    _c, ow = plane_stats_model(*planes, rows, ones, mask, with_counts=False,
                               with_or=True)
    assert ow.any()


def _jplanes(seed, n_samples, p_no_acan):
    rng = random.Random(seed)
    recs = j_random_records(rng, chrom="7", n=300, n_samples=n_samples,
                            p_multiallelic=0.35, p_symbolic=0.1,
                            p_no_acan=p_no_acan)
    for rec in recs[::6]:  # ploidy > 2: count planes saturate
        rec.genotypes[rng.randrange(n_samples)] = "1|1|1"
        rec.ac = rec.an = None
    shard = j_build_index(recs, dataset_id="pm", vcf_location="v",
                          sample_names=[f"S{i}" for i in range(n_samples)])
    return (jpk.PlaneDeviceIndex(shard),
            tpk.PlaneDeviceIndex(shard_from_reference(shard), "cpu"))


@pytest.mark.parametrize("sel", ["none", "some", "all"])
@pytest.mark.parametrize("with_counts", [True, False])
@pytest.mark.parametrize("R", [1, 9, 65, 2047, 7097])
@pytest.mark.parametrize("n_samples", [40, 70])
def test_model_equals_jax_plane_stats(n_samples, R, with_counts, sel):
    """Genotype planes of 40 and 70 samples (two and three words, the
    last a tail word) through JAX ``_plane_stats`` and the model."""
    jp, tp = _jplanes(n_samples, n_samples, p_no_acan=0.5)
    rng = np.random.default_rng(R)
    rows = rng.integers(0, tp.n_rows, R).astype(np.int32)
    or_sel = {"none": np.zeros(R, np.int32), "all": np.ones(R, np.int32),
              "some": (rng.random(R) < 0.3).astype(np.int32)}[sel]
    mask = rng.integers(0, 2**32, tp.n_words, dtype=np.uint32)
    mask[-1] &= (1 << (n_samples % 32)) - 1  # the tail word's samples
    kw = dict(with_counts=with_counts, with_or=sel != "none")
    want = jpk._plane_stats(
        jp.gt, jp.gt2, jp.tok1, jp.tok2, jnp.asarray(rows),
        jnp.asarray(or_sel), jnp.asarray(mask.view(np.int32)), R=R, **kw)
    u32 = lambda t: t.numpy().view(np.uint32)
    planes = ((u32(tp.gt), u32(tp.gt2), u32(tp.tok1), u32(tp.tok2))
              if with_counts else (u32(tp.gt),) * 4)
    got = plane_stats_model(*planes, rows, or_sel, mask, seed=R, **kw)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    if sel == "all":
        assert got[1].any()
