"""The fused-stack bisection query (``bisect_query_kernel`` in
``csrc/bisect_query.cu``, J3) as the card runs it, held against the twin
and JAX.

J3 runs ``csrc/fused_match.cuh``'s ``match_slot`` (the body of J6's
match-only kernel) on a cluster of c = min(8, ceil(W / 256)) blocks a
query, block rank r taking window lanes [r L, r L + L) (L = 256 up to
W = 2048, whole 256-lane chunks beyond), one chunk a round. Each chunk
places its matches by a ballot and a prefix over the
block's warps and decides a record's first match from the previous
matched lane (within the warp by ballot and shuffle, else the last
matched rec_id of the warps and chunks before it); the block's first
match is provisionally first. A window of at most L lanes lies in rank
0 alone: it answers the query with no exchange. Otherwise every block
sends (count, three sums, first match's rec_id and AN, last match's
rec_id) to every block, takes its exclusive prefix over the ranks for
its rows, and the leader takes back the AN of a rank's first match
where the nearest earlier rank with matches ended on the same record.
J3's form: every slot owned, shard ids clamped, stacked row ids, the
exists column first.

A numpy model of those steps (window bounds and the lane predicate from
the twin's search and matcher, ``query_batch_reference``) must equal the
twin query by query, and JAX's ``_query_batch``, and, standing in for
the kernel under ``run_queries``, JAX's ``run_queries``: windows of
1-3000 lanes, records of up to 40 rows cut by chunk and rank edges, R
below, at and above the chunk edges, AC and AN near the int32 ends,
shard ids past the stack, under hypothesis and in named cases.

The kernel itself is held against the twin on the card
(tests/test_torch_cuda.py, chip_smoke.py). Every value is an integer:
the tolerance is 0.
"""

import itertools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sbeacon_tpu.genomics.vcf import VcfRecord as JVcfRecord
from sbeacon_tpu.index.columnar import build_index as j_build_index
from sbeacon_tpu.ops import kernel as jk
from sbeacon_tpu_torch.index import shard_from_reference
from sbeacon_tpu_torch.ops import kernel as tk

CHUNK = 256  # lanes of one block round (the kernel's 256 threads)
WARP = 32
MAX_CLUSTER = 8
SETTINGS = settings(max_examples=60, deadline=None, database=None,
                    derandomize=True)
FIELDS = ("exists", "call_count", "n_variants", "all_alleles_count",
          "n_matched", "overflow")


def _i32(x):
    return int((int(x) + 2**31) % 2**32 - 2**31)


def cluster_shape(W):
    """(blocks a query, lanes a block takes)."""
    chunks = -(-W // CHUNK)
    c = min(chunks, MAX_CLUSTER)
    return c, -(-chunks // c) * CHUNK


def _window(columns, offsets, q, n_iters):
    """[lo, hi) of one query in its clamped segment row, as the twin's
    search finds it (the kernel's block_window equals it: the stacked
    kernels' model, tests/test_torch_stacked_model.py)."""
    k, n_off = offsets.shape
    sid = min(max(int(q[tk.QF_SHARD]), 0), k - 1)
    chrom = int(q[tk.QF_CHROM])
    seg = offsets[sid]
    seg_lo = seg[min(max(chrom, 0), n_off - 1)].long().view(1)
    seg_hi = seg[min(max(chrom + 1, 0), n_off - 1)].long().view(1)
    pos = columns[tk.C_POS]
    lo = tk._bisect_reference(pos, q[tk.QF_START_MIN].view(1), seg_lo,
                              seg_hi, n_iters, upper=False)
    hi = tk._bisect_reference(pos, q[tk.QF_START_MAX].view(1), seg_lo,
                              seg_hi, n_iters, upper=True)
    return int(lo), int(hi)


def _chunk(base, l_end, mset, rec, an, ac, state):
    """One 256-lane chunk from lane ``base`` on (lanes < l_end): the
    ballots, the warps' prefix and carry, the first-match rule. Updates
    ``state`` (the block's running count, sums, last rec_id, first
    match, kept lanes) as the block's threads do."""
    counts, lasts, balls = [], [], []
    for w in range(CHUNK // WARP):
        b0 = base + w * WARP
        ball = sum(1 << i for i in range(WARP)
                   if b0 + i < l_end and b0 + i in mset)
        balls.append(ball)
        counts.append(bin(ball).count("1"))
        lasts.append(rec[b0 + ball.bit_length() - 1] if ball else 0)
    for w, ball in enumerate(balls):
        b0 = base + w * WARP
        have = state["n_kept"] > 0
        carry = state["last_rec"]
        for v in range(w):
            if counts[v]:
                have, carry = True, lasts[v]
        for i in range(WARP):
            if not (ball >> i) & 1:
                continue
            l = b0 + i
            lower = ball & ((1 << i) - 1)
            state["calls"] += int(ac[l])
            state["variants"] += int(ac[l] != 0)
            if lower:
                first = rec[b0 + lower.bit_length() - 1] != rec[l]
            elif have:
                first = carry != rec[l]
            else:  # the block's first match
                first = True
                state["first"] = (rec[l], int(an[l]))
            state["alleles"] += int(an[l]) if first else 0
            state["lanes"].append(l)
    for w in range(CHUNK // WARP - 1, -1, -1):
        if counts[w]:
            state["last_rec"] = lasts[w]
            break
    state["n_kept"] += sum(counts)


def query_model(matched, rec, an, ac, n_valid, W, R):
    """One query over its n_valid window lanes: ``matched`` the matched
    lane indices (ascending), ``rec``/``an``/``ac`` per lane. Returns
    ([call_count, n_variants, all_alleles, n_matched], the first R
    matched lanes, whether rank 0 answered alone) as the launch
    computes them."""
    c, L = cluster_shape(W)
    mset = set(matched)
    solo = n_valid <= L
    fans, kept = [], []
    for r in range(1 if solo else c):
        l_end = min(r * L + L, n_valid)
        state = dict(n_kept=0, calls=0, variants=0, alleles=0, last_rec=0,
                     first=None, lanes=[])
        for l0 in range(r * L, l_end, CHUNK):
            _chunk(l0, l_end, mset, rec, an, ac, state)
        fans.append(state)
        kept += state["lanes"]  # rank r's rows follow the earlier ranks'
    calls = variants = alleles = 0
    have, carry = False, None
    for f in fans:
        calls += f["calls"]
        variants += f["variants"]
        alleles += f["alleles"]
        if not f["n_kept"]:
            continue
        if have and carry == f["first"][0]:
            alleles -= f["first"][1]
        have, carry = True, f["last_rec"]
    total = sum(f["n_kept"] for f in fans)
    return ([_i32(calls), _i32(variants), _i32(alleles), total], kept[:R],
            solo)


def j3_model(columns, alt_prefix, offsets, qpack, *, window_cap, record_cap,
             n_iters):
    """``query_batch_reference``'s output from the launch model."""
    W, R = window_cap, min(record_cap, window_cap)
    # every matched row of each window (n_valid <= W), from the twin
    full = tk.query_batch_reference(columns, alt_prefix, offsets, qpack,
                                    window_cap=W, record_cap=W,
                                    n_iters=n_iters)
    rec = columns[tk.C_REC_ID].numpy()
    an = columns[tk.C_AN].numpy()
    ac = columns[tk.C_AC].numpy()
    out = np.full((qpack.shape[0], tk.N_AGG + R), -1, np.int64)
    for j in range(qpack.shape[0]):
        lo, hi = _window(columns, offsets, qpack[j], n_iters)
        n_valid = max(0, min(hi - lo, W))
        matched = [int(r) - lo for r in full[j, tk.N_AGG:].numpy() if r >= 0]
        assert all(0 <= l < n_valid for l in matched)
        sl = slice(lo, lo + n_valid)
        sums, kept, _solo = query_model(matched, rec[sl], an[sl], ac[sl],
                                        n_valid, W, R)
        out[j, :tk.N_AGG] = [int(sums[0] > 0), *sums, int(hi - lo > W)]
        out[j, tk.N_AGG:tk.N_AGG + len(kept)] = [lo + l for l in kept]
    return torch.from_numpy(out.astype(np.int32))


def _alts(k):
    pool = ["".join(p) for n in (1, 2, 3) for p in itertools.product(
        "ACGT", repeat=n)]
    return pool[:k]


def _records(rng, sizes, chrom="3", start=1000):
    """Records of the given alt counts at increasing positions, AC and AN
    near the int32 ends now and then."""
    recs = []
    pos = start
    for k in sizes:
        pos += rng.choice([1, 1, 2, 5])
        ac = [rng.choice([0, 1, 3, 2**31 - 1, -7]) for _ in range(k)]
        recs.append(JVcfRecord(chrom=chrom, pos=pos, ref="A", alts=_alts(k),
                               vt="N/A", ac=ac,
                               an=rng.choice([10, 2**31 - 5, 77]),
                               genotypes=[]))
    return recs


def _jshards(seed, n, lens, n_recs=1100):
    rng = random.Random(seed)
    return [j_build_index(_records(rng, [rng.choice(lens)
                                         for _ in range(n_recs)]),
                          dataset_id=f"b{d}", vcf_location=f"b{d}.vcf")
            for d in range(n)]


def _specs(shards, rng, n, widths):
    """Any-base, typed, exact and length-bounded queries whose windows
    span ``widths`` rows, on every shard."""
    specs, sids = [], []
    for _ in range(n):
        sid = rng.randrange(len(shards))
        pos = shards[sid].cols["pos"]
        i = rng.randrange(len(pos))
        last = min(i + rng.choice(widths), len(pos) - 1)
        kw = rng.choice([dict(alternate_bases="N"), dict(variant_type="INS"),
                         dict(alternate_bases="A"),
                         dict(alternate_bases="N", variant_max_length=2)])
        specs.append((("3", int(pos[i]), int(pos[last])), kw))
        sids.append(sid)
    return specs, sids


def _qpack(specs, sids):
    enc = tk.encode_queries([tk.QuerySpec(c, a, b, 1, 1 << 30, **kw)
                             for (c, a, b), kw in specs], shard_ids=sids)
    return torch.from_numpy(tk.pack_queries(enc, fused=True))


def _stack(jshards):
    return (jk.FusedDeviceIndex(jshards, pad_unit=1024),
            tk.FusedDeviceIndex([shard_from_reference(s) for s in jshards],
                                "cpu", pad_unit=1024))


@st.composite
def _cases(draw):
    seed = draw(st.integers(0, 2**20))
    lens = draw(st.sampled_from([(1, 2, 3), (1, 12, 40), (30, 40), (1,)]))
    W = draw(st.sampled_from([1, 200, 256, 257, 700, 1400, 2048, 3000]))
    R = draw(st.sampled_from([0, 1, 16, 255, 256, 257, 1024, 3000]))
    return seed, lens, W, R


@SETTINGS
@given(_cases())
def test_model_equals_twin(case):
    """Random records of 1-40 rows, windows up to past W, R below, at
    and above the chunk and rank edges."""
    seed, lens, W, R = case
    shards = [shard_from_reference(s) for s in _jshards(seed, 3, lens)]
    index = tk.FusedDeviceIndex(shards, "cpu", pad_unit=1024)
    rng = random.Random(seed)
    specs, sids = _specs(shards, rng, 8, [0, 3, 255, 256, 300, 1500, 2100,
                                          4000])
    q = _qpack(specs, sids)
    kw = dict(window_cap=W, record_cap=R, n_iters=index.n_iters)
    want = tk.query_batch_reference(index.columns, index.alt_prefix,
                                    index.offsets, q, **kw)
    got = j3_model(index.columns, index.alt_prefix, index.offsets, q, **kw)
    assert torch.equal(got, want)


def test_cluster_shape():
    """Blocks a query and lanes a block takes."""
    assert [cluster_shape(W) for W in (1, 256, 257, 1400, 2048, 2049,
                                       4096)] == [
        (1, 256), (1, 256), (2, 256), (6, 256), (8, 256), (8, 512),
        (8, 512)]


def test_first_match_carry_across_chunks_and_ranks():
    """A record of 40 rows cut by every chunk edge of a 2048-lane
    window: its first match in a later chunk or rank is not first when
    an earlier one matched the record; a chunk or rank with no match
    passes the carry on from the one before it; the leader takes a
    rank's first AN back. Both shapes agree with the rule."""
    rec = np.repeat(np.arange(60), 40)[:2048]
    an = (np.arange(2048) % 7 + 1) * 10
    ac = np.ones(2048, np.int64)
    for matched in ([250, 251, 256, 300], [255, 256, 511, 512, 513],
                    [200, 600], [239, 760, 1000, 1023], [10, 1800],
                    list(range(2048))):
        want = sum(int(an[l]) for l in matched
                   if not any(rec[p] == rec[l] for p in matched if p < l))
        sums, kept, solo = query_model(matched, rec, an, ac, 2048, 2048,
                                       1024)
        assert sums[2] == want and sums[3] == len(matched)
        assert kept == sorted(matched)[:1024] and not solo


@pytest.mark.parametrize("n_valid", [0, 1, 255, 256, 257, 511, 1400, 2048])
def test_rank_zero_alone_exactly_when_its_lanes_hold_the_window(n_valid):
    """The cluster shape's rank 0 answers alone iff the window fits its
    256 lanes; its answer equals every rank's."""
    rec = np.arange(2048) // 3
    an = np.full(2048, 5)
    ac = np.arange(2048) % 2
    matched = list(range(0, n_valid, 2))
    sums, kept, solo = query_model(matched, rec, an, ac, n_valid, 2048, 100)
    assert solo == (n_valid <= CHUNK)
    assert sums[3] == len(matched) and kept == matched[:100]
    assert sums[2] == 5 * len({int(rec[l]) for l in matched})


def test_compaction_offsets_past_R():
    """Rows of later ranks start at the earlier ranks' match count and
    stop at R; n_matched counts every match."""
    rec = np.arange(3000)
    an = np.ones(3000, np.int64)
    ac = np.ones(3000, np.int64)
    matched = [0, 5, 300, 301, 900, 2047, 2048, 2999]
    for R in (0, 1, 3, 4, 5, 8, 2048):
        sums, kept, _solo = query_model(matched, rec, an, ac, 3000, 3000, R)
        assert kept == matched[:R] and sums[3] == len(matched)


@pytest.mark.parametrize("W,R", [(2048, 1024), (2048, 1), (700, 257),
                                 (257, 64), (256, 16), (3000, 3000),
                                 (1, 1)])
@pytest.mark.parametrize("lens", [(1, 2, 3), (1, 12, 40)])
def test_model_equals_jax_query_batch(lens, W, R):
    """The model on the port's stack equals XLA ``_query_batch`` on the
    JAX package's, shard ids past the stack included (they clamp)."""
    jshards = _jshards(len(lens) * 5 + W, 4, lens)
    jf, tf = _stack(jshards)
    shards = [shard_from_reference(s) for s in jshards]
    specs, sids = _specs(shards, random.Random(W + R), 24,
                         [0, 2, 255, 257, 600, 2047, 2500, 5000])
    sids[0], sids[1] = 4, 9  # past the 4 shards: clamped like an XLA gather
    q = _qpack(specs, sids)
    enc = jk.encode_queries([jk.QuerySpec(c, a, b, 1, 1 << 30, **kw)
                             for (c, a, b), kw in specs], shard_ids=sids)
    want = jk._query_batch(jf.arrays, {k: jnp.asarray(v)
                                       for k, v in enc.items()},
                           window_cap=W, record_cap=R, n_iters=jf.n_iters)
    got = j3_model(tf.columns, tf.alt_prefix, tf.offsets, q, window_cap=W,
                   record_cap=R, n_iters=tf.n_iters).numpy()
    for k, name in enumerate(FIELDS):
        np.testing.assert_array_equal(
            got[:, k], np.asarray(want[name]).astype(np.int32),
            err_msg=name)
    np.testing.assert_array_equal(got[:, tk.N_AGG:], np.asarray(want["rows"]))
    assert (np.asarray(want["n_matched"]) > min(R, W)).any() or R >= W


@pytest.mark.parametrize("seed", [5, 6])
def test_model_in_run_queries_equals_jax(monkeypatch, seed):
    """The model in place of the kernel under the port's run_queries
    answers as JAX's run_queries does, field by field."""
    jshards = _jshards(13 + seed, 5, (1, 12, 40))
    jf, tf = _stack(jshards)
    shards = [shard_from_reference(s) for s in jshards]
    specs, sids = _specs(shards, random.Random(seed), 40,
                         [0, 3, 255, 257, 1400, 2100, 5000])
    want = jk.run_queries(jf, jk.encode_queries(
        [jk.QuerySpec(c, a, b, 1, 1 << 30, **kw) for (c, a, b), kw in specs],
        shard_ids=sids), window_cap=2048, record_cap=1024)

    # the wrapper's family keyword names its launch record: the model
    # records nothing
    monkeypatch.setattr(tk, "bisect_query",
                        lambda *a, family="fused", **kw: (j3_model(*a, **kw),
                                                          None))
    got = tk.run_queries(tf, tk.encode_queries(
        [tk.QuerySpec(c, a, b, 1, 1 << 30, **kw) for (c, a, b), kw in specs],
        shard_ids=sids), window_cap=2048, record_cap=1024)
    for name in FIELDS + ("rows",):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.overflow.any() and (got.n_matched > 1024).any()
