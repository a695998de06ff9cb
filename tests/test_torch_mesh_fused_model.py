"""The owner-sliced fused query's match-only body (``mesh_fused_kernel``
in ``csrc/mesh_fused.cu``, J6) as the card runs it, held against the
twin and JAX.

J6 answers each output slot with a cluster of c = min(8, ceil(W / 256))
blocks; block rank r takes window lanes [r L, r L + L) (L = 256 up to
W = 2048, whole 256-lane chunks beyond) in chunks of 256, places each
match by a ballot and a prefix over its warps, and decides its record's
first match from the previous matched lane (within the warp by ballot
and shuffle, else the last matched rec_id of the warps and chunks
before it); the block's first match is provisionally first. Each block
sends (count, three sums, first match's rec_id and AN, last match's
rec_id) to every block; each takes its exclusive prefix over the ranks
for its rows, and the leader takes back the AN of a rank's first match
where the nearest earlier rank with matches ended on the same record.

A numpy model of those steps (window bounds and the lane predicate from
the twin's search and matcher, ``query_batch_reference``) must equal
``local_fused_reference`` entry by entry, and, standing in for the
kernel under ``MeshFusedIndex.run_mesh_queries``, JAX's
``MeshFusedIndex`` (``_local_fused_query`` on each of its devices):
windows of 1-3000 lanes, chunk boundaries that cut records of up to 40
rows, R truncation at and around the chunk and cluster edges, and the
owner, sliced-combine and replicated layouts, under hypothesis and in
named cases.

The kernel itself is held against the twin on the card
(tests/test_torch_cuda.py, chip_smoke.py). Every value is an integer:
the tolerance is 0.
"""

import itertools
import random

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sbeacon_tpu.genomics.vcf import VcfRecord as JVcfRecord
from sbeacon_tpu.index.columnar import build_index as j_build_index
from sbeacon_tpu.ops.kernel import QuerySpec as JQuerySpec
from sbeacon_tpu.ops.kernel import encode_queries as j_encode_queries
from sbeacon_tpu.parallel import mesh as jm
from sbeacon_tpu_torch.index import shard_from_reference
from sbeacon_tpu_torch.ops import kernel as tk
from sbeacon_tpu_torch.ops.kernel import QuerySpec, encode_queries
from sbeacon_tpu_torch.parallel import mesh as tm

CPU = torch.device("cpu")
CHUNK = 256  # lanes of one block round (the kernel's 256 threads)
WARP = 32
MAX_CLUSTER = 8
SETTINGS = settings(max_examples=60, deadline=None, database=None,
                    derandomize=True)
FIELDS = ("exists", "call_count", "n_variants", "all_alleles_count",
          "n_matched", "overflow", "rows")


def _i32(x):
    return int((int(x) + 2**31) % 2**32 - 2**31)


def cluster_shape(W):
    """(blocks of a slot's cluster, lanes a block takes)."""
    chunks = -(-W // CHUNK)
    c = min(chunks, MAX_CLUSTER)
    return c, -(-chunks // c) * CHUNK


def _window(columns, offsets, q, sid, n_iters):
    """[lo, hi) of one query in segment row offsets[sid], as the twin's
    search finds it (the kernel's block_window equals it: the stacked
    kernels' model, tests/test_torch_stacked_model.py)."""
    chrom = int(q[tk.QF_CHROM])
    seg = offsets[sid]
    n_off = seg.shape[0]
    seg_lo = seg[min(max(chrom, 0), n_off - 1)].long().view(1)
    seg_hi = seg[min(max(chrom + 1, 0), n_off - 1)].long().view(1)
    pos = columns[tk.C_POS]
    lo = tk._bisect_reference(pos, q[tk.QF_START_MIN].view(1), seg_lo,
                              seg_hi, n_iters, upper=False)
    hi = tk._bisect_reference(pos, q[tk.QF_START_MAX].view(1), seg_lo,
                              seg_hi, n_iters, upper=True)
    return int(lo), int(hi)


def slot_model(matched, rec, an, ac, n_valid, W, R):
    """One owned slot over its n_valid window lanes: ``matched`` the
    matched lane indices (ascending), ``rec``/``an``/``ac`` per lane.
    Returns (agg [call_count, n_variants, all_alleles, n_matched],
    the first R matched lanes) as the cluster computes them."""
    c, L = cluster_shape(W)
    mset = set(matched)
    fans = []
    kept = []
    for r in range(c):
        l_end = min(r * L + L, n_valid)
        calls = variants = alleles = 0
        n_kept = 0
        last_rec = 0
        first_rec = first_an = None
        lanes = []
        for l0 in range(r * L, l_end, CHUNK):
            counts, lasts = [], []
            balls = []
            for w in range(CHUNK // WARP):
                base = l0 + w * WARP
                ball = sum(1 << i for i in range(WARP)
                           if base + i < l_end and base + i in mset)
                balls.append(ball)
                counts.append(bin(ball).count("1"))
                lasts.append(rec[base + ball.bit_length() - 1] if ball else 0)
            for w, ball in enumerate(balls):
                base = l0 + w * WARP
                have = n_kept > 0
                carry = last_rec
                for v in range(w):
                    if counts[v]:
                        have, carry = True, lasts[v]
                for i in range(WARP):
                    if not (ball >> i) & 1:
                        continue
                    l = base + i
                    lower = ball & ((1 << i) - 1)
                    calls += int(ac[l])
                    variants += int(ac[l] != 0)
                    if lower:
                        first = rec[base + lower.bit_length() - 1] != rec[l]
                    elif have:
                        first = carry != rec[l]
                    else:  # the block's first match
                        first = True
                        first_rec, first_an = rec[l], int(an[l])
                    alleles += int(an[l]) if first else 0
                    lanes.append(l)
            for w in range(CHUNK // WARP - 1, -1, -1):
                if counts[w]:
                    last_rec = lasts[w]
                    break
            n_kept += sum(counts)
        fans.append((n_kept, calls, variants, alleles, first_rec, first_an,
                     last_rec))
        kept += lanes  # rank r's lanes follow the earlier ranks' (prefix)
    calls = variants = alleles = 0
    have, carry = False, None
    for n_kept, c_, v_, a_, f_rec, f_an, l_rec in fans:
        calls, variants, alleles = calls + c_, variants + v_, alleles + a_
        if not n_kept:
            continue
        if have and carry == f_rec:
            alleles -= f_an
        have, carry = True, l_rec
    total = sum(f[0] for f in fans)
    return [_i32(calls), _i32(variants), _i32(alleles), total], kept[:R]


def j6_model(columns, alt_prefix, offsets, seg_base, qpack, *, me, d_local,
             n_dev, C, layout, window_cap, record_cap, n_iters, planes=None,
             masks=None, use_counts=None, has_counts=False):
    """``local_fused_reference``'s outputs (match-only) from the cluster
    model."""
    assert planes is None
    W, R = window_cap, min(record_cap, window_cap)
    s = qpack.shape[0]
    sid = qpack[:, tk.QF_SHARD].long() - me * d_local
    owned = (sid >= 0) & (sid < d_local)
    q = qpack.clone()
    q[:, tk.QF_SHARD] = sid.clamp(0, d_local - 1).to(torch.int32)
    # every matched row of each window (n_valid <= W), from the twin
    full = tk.query_batch_reference(columns, alt_prefix, offsets, q,
                                    window_cap=W, record_cap=W,
                                    n_iters=n_iters)
    combine = layout != tm.LAYOUT_OWNER
    agg = np.zeros((s, 5), np.int64)
    rows = np.full((s, R), 0 if combine else -1, np.int64)
    rec = columns[tk.C_REC_ID].numpy()
    an = columns[tk.C_AN].numpy()
    ac = columns[tk.C_AC].numpy()
    for j in range(s):
        if not owned[j]:
            continue
        k = int(q[j, tk.QF_SHARD])
        lo, hi = _window(columns, offsets, q[j], k, n_iters)
        n_valid = max(0, min(hi - lo, W))
        got = full[j, tk.N_AGG:].numpy()
        matched = [int(r) - lo for r in got if r >= 0]
        assert all(0 <= l < n_valid for l in matched)
        sl = slice(lo, lo + n_valid)
        sums, kept = slot_model(matched, rec[sl], an[sl], ac[sl], n_valid,
                                W, R)
        agg[j] = sums + [int(hi - lo > W)]
        base = int(seg_base[k])
        for i, l in enumerate(kept):
            rows[j, i] = lo + l - base + int(combine)
    out = {"agg": torch.from_numpy(agg.astype(np.int32)),
           "rows": torch.from_numpy(rows.astype(np.int32))}
    if layout == tm.LAYOUT_SLICED:
        for key, v in out.items():
            buf = torch.zeros((n_dev * C,) + tuple(v.shape[1:]),
                              dtype=torch.int32)
            buf[me * C:me * C + s] = v
            out[key] = buf
    return out


def _alts(k):
    pool = ["".join(p) for n in (1, 2, 3) for p in itertools.product(
        "ACGT", repeat=n)]
    return pool[:k]


def _records(rng, sizes, start=1000):
    """Records of the given alt counts at increasing positions, AC and AN
    near the int32 ends now and then."""
    recs = []
    pos = start
    for k in sizes:
        pos += rng.choice([1, 1, 2, 5])
        ac = [rng.choice([0, 1, 3, 2**31 - 1, -7]) for _ in range(k)]
        recs.append(JVcfRecord(chrom="3", pos=pos, ref="A", alts=_alts(k),
                               vt="N/A", ac=ac,
                               an=rng.choice([10, 2**31 - 5, 77]),
                               genotypes=[]))
    return recs


def _jshards(seed, n, lens):
    rng = random.Random(seed)
    return [j_build_index(_records(rng, [rng.choice(lens)
                                         for _ in range(1100)]),
                          dataset_id=f"m{d}", vcf_location=f"m{d}.vcf")
            for d in range(n)]


def _specs(shards, rng, n, widths):
    """Any-base, typed and exact queries whose windows span ``widths``
    rows, on every shard."""
    specs, sids = [], []
    for _ in range(n):
        sid = rng.randrange(len(shards))
        pos = shards[sid].cols["pos"]
        i = rng.randrange(len(pos))
        last = min(i + rng.choice(widths), len(pos) - 1)
        kw = rng.choice([dict(alternate_bases="N"), dict(variant_type="INS"),
                         dict(alternate_bases="A"), dict(alternate_bases="N",
                                                         variant_max_length=2)])
        specs.append((("3", int(pos[i]), int(pos[last])), kw))
        sids.append(sid)
    return specs, sids


def _enc(cls, enc_fn, specs, sids):
    return enc_fn([cls(c, a, b, 1, 1 << 30, **kw) for (c, a, b), kw in specs],
                  shard_ids=sids)


def _entries_equal_twin(mfi, enc, layout, W, R):
    for blk, q, kw in mfi.launch_inputs(enc, layout)[0]:
        kw = dict(kw, window_cap=W, record_cap=R)
        args = (blk.columns, blk.alt_prefix, blk.offsets, blk.seg_base, q)
        want = tm.local_fused_reference(*args, **kw)
        got = j6_model(*args, **kw)
        for k in want:
            assert torch.equal(got[k], want[k]), k


@st.composite
def _cases(draw):
    seed = draw(st.integers(0, 2**20))
    lens = draw(st.sampled_from([(1, 2, 3), (1, 12, 40), (30, 40), (1,)]))
    W = draw(st.sampled_from([1, 200, 256, 257, 700, 2048, 3000]))
    R = draw(st.sampled_from([1, 16, 255, 256, 257, 1024, 3000]))
    n_dev = draw(st.sampled_from([1, 2, 3]))
    layout = draw(st.sampled_from([tm.LAYOUT_OWNER, tm.LAYOUT_SLICED,
                                   tm.LAYOUT_REPLICATED]))
    return seed, lens, W, R, n_dev, layout


@SETTINGS
@given(_cases())
def test_model_equals_twin(case):
    """Random records of 1-40 rows, windows up to past W, every layout,
    R below, at and above the chunk and cluster edges."""
    seed, lens, W, R, n_dev, layout = case
    shards = [shard_from_reference(s) for s in _jshards(seed, 3, lens)]
    mfi = tm.MeshFusedIndex(shards, tm.make_mesh(devices=[CPU] * n_dev))
    rng = random.Random(seed)
    specs, sids = _specs(shards, rng, 6, [0, 3, 255, 256, 300, 1500, 2100,
                                          4000])
    _entries_equal_twin(mfi, _enc(QuerySpec, encode_queries, specs, sids),
                        layout, W, R)


def test_cluster_shape():
    """Blocks and lanes a block of the match-only cluster takes."""
    assert [cluster_shape(W) for W in (1, 256, 257, 2048, 2049, 4096)] == [
        (1, 256), (1, 256), (2, 256), (8, 256), (8, 512), (8, 512)]


def test_first_match_carry_across_chunk_boundaries():
    """A record of 40 rows cut by every chunk boundary of a 2048-lane
    window: its first match in a later block is not first when an
    earlier block matched the record; a block with no match passes the
    carry on from the one before it."""
    rec = np.repeat(np.arange(60), 40)[:2048]
    an = (np.arange(2048) % 7 + 1) * 10
    ac = np.ones(2048, np.int64)
    for matched in ([250, 251, 256, 300], [255, 256, 511, 512, 513],
                    [200, 600], [239, 760, 1000, 1023], list(range(2048))):
        sums, kept = slot_model(matched, rec, an, ac, 2048, 2048, 1024)
        want = sum(int(an[l]) for l in matched
                   if not any(rec[p] == rec[l] for p in matched if p < l))
        assert sums[2] == want and sums[3] == len(matched)
        assert kept == sorted(matched)[:1024]


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return jm.make_mesh(8)


_JAX: dict = {}


@pytest.mark.parametrize("lens", [(1, 2, 3), (1, 12, 40)])
@pytest.mark.parametrize("W,R", [(2048, 1024), (700, 257), (256, 16),
                                 (3000, 3000)])
@pytest.mark.parametrize("n_mesh", [1, 2, 3])
@pytest.mark.parametrize("layout", [tm.LAYOUT_OWNER, tm.LAYOUT_SLICED,
                                    tm.LAYOUT_REPLICATED])
def test_model_in_run_mesh_queries_equals_jax(jmesh, monkeypatch, lens, W, R,
                                              n_mesh, layout):
    """The model in place of the kernel under the port's
    run_mesh_queries answers every (shard, query) pair as JAX's
    MeshFusedIndex does (its _local_fused_query on 8 devices), in every
    layout, and each entry equals the twin."""
    jshards = _jshards(len(lens) * 7 + W, 4, lens)
    shards = [shard_from_reference(s) for s in jshards]
    rng = random.Random(W + R)
    specs, sids = _specs(shards, rng, 24, [0, 2, 255, 257, 600, 2047, 2500,
                                           5000])
    key = (lens, W, R)
    if key not in _JAX:
        _JAX[key] = jm.MeshFusedIndex(jshards, jmesh).run_mesh_queries(
            dict(_enc(JQuerySpec, j_encode_queries, specs, sids)),
            window_cap=W, record_cap=R)
    want = _JAX[key]
    mfi = tm.MeshFusedIndex(shards, tm.make_mesh(devices=[CPU] * n_mesh),
                            layout=layout)
    enc = _enc(QuerySpec, encode_queries, specs, sids)
    _entries_equal_twin(mfi, enc, layout, W, R)
    monkeypatch.setattr(tm, "mesh_fused",
                        lambda *a, **kw: (j6_model(*a, **kw), None))
    got = mfi.run_mesh_queries(enc, window_cap=W, record_cap=R)
    for name in FIELDS:
        assert np.array_equal(np.asarray(getattr(got, name)),
                              np.asarray(getattr(want, name))), name
    assert (np.asarray(want.n_matched) > min(R, W)).any() or R >= W
