"""The port's delta tail and its L0 index against the JAX package's.

Each case feeds the same seeded base shards and the same sequence of
delta publishes, folds and searches to a JAX engine and a port engine
(``device="cpu"``: the bisection kernel runs its plain-PyTorch twin)
and compares, at tolerance 0, ``dataclasses.asdict`` of every response,
the delta registry, the L0 status and counters, the cost charges of the
tail and the plan stages. The cases are those of
``tests/test_delta_ingest.py`` that need no compactor (the fold is the
engine call the compactor makes: ``add_index`` of the merged shard with
``meta['delta_epoch']``), the pod tier's tail leg, the L0 segment tables
against the JAX package's, and the failures that raise.
"""

import dataclasses
import random
import threading
import time

import jax
import numpy as np
import pytest
import torch

import sbeacon_tpu.telemetry as jtel
from sbeacon_tpu.config import BeaconConfig as JBeaconConfig
from sbeacon_tpu.config import EngineConfig as JEngineConfig
from sbeacon_tpu.engine import VariantEngine as JVariantEngine
from sbeacon_tpu.genomics.vcf import VcfRecord
from sbeacon_tpu.index.columnar import build_index as j_build_index
from sbeacon_tpu.index.columnar import merge_shards as j_merge_shards
from sbeacon_tpu.ops.kernel import CompositeL0DeviceIndex as JComposite
from sbeacon_tpu.ops.kernel import L0DeviceIndex as JL0DeviceIndex
from sbeacon_tpu.parallel.dispatch import MeshDispatchTier as JTier
from sbeacon_tpu.payloads import VariantQueryPayload as JPayload
from sbeacon_tpu.testing import random_records
import sbeacon_tpu_torch.engine as t_engine
import sbeacon_tpu_torch.telemetry as ttel
from sbeacon_tpu_torch.config import BeaconConfig, EngineConfig
from sbeacon_tpu_torch.engine import VariantEngine
from sbeacon_tpu_torch.harness import faults
from sbeacon_tpu_torch.index import merge_shards, shard_from_reference
from sbeacon_tpu_torch.ops import kernel as tk
from sbeacon_tpu_torch.parallel.dispatch import MeshDispatchTier
from sbeacon_tpu_torch.payloads import VariantQueryPayload
from torch_ingest_corpus import no_thread_leak  # noqa: F401

SAMPLES = ["S0", "S1"]
CPU = torch.device("cpu")


def _rec(chrom, pos, ref="A", alt="T"):
    return VcfRecord(chrom=chrom, pos=pos, ref=ref, alts=[alt], ac=[1],
                     an=4, vt="SNP", genotypes=["0|1", "0|0"])


def _shard(records, ds="dsA", vcf="a.vcf"):
    return j_build_index(records, dataset_id=ds, vcf_location=vcf,
                         sample_names=SAMPLES)


def _doc(chrom="1", lo=1, hi=1 << 29, datasets=(), gran="count",
         include="HIT", alt="N", **kw):
    return dict(dataset_ids=list(datasets), reference_name=chrom,
                start_min=lo, start_max=hi, end_min=lo, end_max=hi + 64,
                alternate_bases=alt, requested_granularity=gran,
                include_datasets=include, **kw)


def _asd(rs):
    return [dataclasses.asdict(r) for r in rs]


def _variants(rs):
    return {v for r in rs for v in r.variants}


def _status(eng):
    st = eng.l0_status()
    st.pop("ageS", None)
    return st


class Twin:
    """A JAX engine and a port engine fed the same publishes; searches
    run under a request context in each package, and the responses, the
    tail's ``delta_shards`` charge and the plan's stage decisions are
    compared, with the registry and the L0 status."""

    def __init__(self, shards, **over):
        over.setdefault("use_mesh", False)
        self.j = JVariantEngine(JBeaconConfig(engine=JEngineConfig(**over)))
        self.t = VariantEngine(BeaconConfig(engine=EngineConfig(**over)),
                               device="cpu")
        for s in shards:
            self.add_index(s)

    def add_index(self, shard):
        self.j.add_index(shard)
        self.t.add_index(shard_from_reference(shard))

    def add_delta(self, shard):
        epoch = self.j.add_delta(shard)
        assert self.t.add_delta(shard_from_reference(shard)) == epoch
        self.same_state()
        return epoch

    def fold(self, key):
        """The compactor's fold, made by hand: the key's base and tail
        merged, published with the highest folded epoch."""
        (_k, base, tail), = self.j.delta_snapshot(key)
        merged = j_merge_shards([base] + [s for _e, s in tail])
        merged.meta.update(dataset_id=key[0], vcf_location=key[1],
                           delta_epoch=tail[-1][0])
        (_k, tbase, ttail), = self.t.delta_snapshot(key)
        tmerged = merge_shards([tbase] + [s for _e, s in ttail])
        tmerged.meta.update(dataset_id=key[0], vcf_location=key[1],
                            delta_epoch=ttail[-1][0])
        self.j.add_index(merged)
        self.t.add_index(tmerged)
        self.same_state()

    def same_state(self):
        assert self.t.delta_stats() == self.j.delta_stats()
        assert self.t.delta_metrics() == self.j.delta_metrics()
        assert _status(self.t) == _status(self.j)
        assert self.t.index_fingerprint() == self.j.index_fingerprint()
        assert self.t.base_fingerprint() == self.j.base_fingerprint()
        assert self.t.datasets() == self.j.datasets()

    def search(self, doc, *, same_history=True):
        jctx = jtel.RequestContext(route="test")
        with jtel.request_context(jctx):
            want = self.j.search(JPayload(**doc))
        tctx = ttel.RequestContext(route="test")
        with ttel.request_context(tctx):
            got = self.t.search(VariantQueryPayload(**doc))
        assert _asd(got) == _asd(want), doc
        if same_history:
            assert tctx.cost.delta_shards == jctx.cost.delta_shards, doc
            assert tctx.cost.cache == jctx.cost.cache
            assert _split(tctx) == _split(jctx), doc
            assert _status(self.t) == _status(self.j)
        return got, tctx

    def close(self):
        self.j.close()
        self.t.close()


def _split(ctx):
    """The plan's non-batch stages (the batch stage names the serving
    index class, which differs where the JAX engine routes a single
    dataset through its fused stack on the CPU)."""
    return [e for e in ctx.plan if e["stage"] != "batch"]


@pytest.fixture
def twin():
    made = []

    def make(*shards, **over):
        t = Twin(shards, **over)
        made.append(t)
        return t

    yield make
    for t in made:
        t.close()


def _deep_tail(twin, rng_seed=60, n=500, cut=300, n_deltas=5, **over):
    recs = random_records(random.Random(rng_seed), chrom="1", n=n,
                          n_samples=2)
    tw = twin(_shard(recs[:cut]), **over)
    step = (n - cut) // n_deltas
    for i in range(n_deltas):
        hi = cut + (i + 1) * step if i < n_deltas - 1 else n
        tw.add_delta(_shard(recs[cut + i * step:hi]))
    return tw, recs


# -- read-your-writes and parity ---------------------------------------------


def test_delta_publish_is_immediately_queryable(twin):
    tw = twin(_shard(random_records(random.Random(1), chrom="1", n=80,
                                    n_samples=2)))
    miss, _ = tw.search(_doc(chrom="2"))
    assert not any(r.exists for r in miss)
    t0 = time.perf_counter()
    tw.add_delta(_shard([_rec("2", 777)]))
    hit, _ = tw.search(_doc(chrom="2"))
    assert time.perf_counter() - t0 < 5.0
    assert any(r.exists for r in hit)
    assert any("777" in v for v in _variants(hit))
    assert tw.t.delta_stats()["dsA"]["shards"] == 1
    assert tw.t.delta_depth("dsA", "a.vcf") == 1
    assert tw.t.delta_tail("dsA", "a.vcf") == tw.j.delta_tail("dsA", "a.vcf")


@pytest.mark.parametrize("gran", ["boolean", "count", "record"])
@pytest.mark.parametrize("alt", [None, "N", "T"])
def test_base_plus_delta_matches_monolith_across_granularities(twin, gran,
                                                               alt):
    recs = random_records(random.Random(11), chrom="1", n=300, n_samples=2)
    cut1, cut2 = len(recs) // 2, 3 * len(recs) // 4
    split = twin(_shard(recs[:cut1]))
    split.add_delta(_shard(recs[cut1:cut2]))
    split.add_delta(_shard(recs[cut2:]))
    mono = twin(_shard(recs))
    q = _doc(gran=gran, alt=alt)
    rs, _ = split.search(q)
    rm, _ = mono.search(q)
    assert any(r.exists for r in rs) == any(r.exists for r in rm)
    if gran != "boolean":
        assert _variants(rs) == _variants(rm)
        assert sum(r.call_count for r in rs) == sum(r.call_count for r in rm)
        assert (sum(r.all_alleles_count for r in rs)
                == sum(r.all_alleles_count for r in rm))


def test_concurrent_queries_during_continuous_ingest(twin):
    """Queries racing a stream of delta publishes (through the L0
    rebuilds past its threshold) never error and end consistent, equal
    to the JAX engine fed the same stream."""
    tw = twin(_shard([_rec("1", 100)]))
    errors: list = []
    stop = threading.Event()

    def publisher():
        for i in range(20):
            tw.t.add_delta(shard_from_reference(
                _shard([_rec("1", 10_000 + 100 * i)])))
            time.sleep(0.002)
        stop.set()

    def querier():
        while not stop.is_set():
            try:
                tw.t.search(VariantQueryPayload(**_doc()))
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                return

    threads = [threading.Thread(target=publisher)] + [
        threading.Thread(target=querier) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors[:1]
    for i in range(20):
        tw.j.add_delta(_shard([_rec("1", 10_000 + 100 * i)]))
    # the port's engine served the racing queriers too: its answer may
    # come from its cache (kept fresh by the scoped invalidations), and
    # its L0 served more queries than the JAX engine's
    got, _ = tw.search(_doc(), same_history=False)
    want = {100} | {10_000 + 100 * i for i in range(20)}
    assert {int(v.split("\t")[1]) for v in _variants(got)} == want
    assert tw.t.delta_stats()["dsA"]["shards"] == 20
    assert tw.t.delta_stats() == tw.j.delta_stats()
    assert tw.t.index_fingerprint() == tw.j.index_fingerprint()


def test_fingerprint_split_and_epoch_monotonicity(twin):
    tw = twin(_shard([_rec("1", 1000)]))
    base_fp = tw.t.base_fingerprint()
    full_fp = tw.t.index_fingerprint()
    cache_other = tw.t.cache_fingerprint(["dsB"])
    tw.add_delta(_shard([_rec("1", 2000)]))
    assert tw.t.base_fingerprint() == base_fp
    assert tw.t.index_fingerprint() != full_fp
    assert tw.t.cache_fingerprint(["dsB"]) == cache_other
    assert tw.t.dataset_fingerprints() == tw.j.dataset_fingerprints()
    tw.fold(("dsA", "a.vcf"))
    assert tw.t.delta_stats() == {}
    assert tw.t.base_fingerprint() != base_fp
    assert tw.add_delta(_shard([_rec("1", 3000)])) == 2
    tw.search(_doc())


def test_fused_stack_stays_clean_across_delta_publish(twin):
    shards = [
        _shard(random_records(random.Random(20 + i), chrom="1", n=120,
                              n_samples=2), ds=f"d{i}", vcf=f"v{i}")
        for i in range(3)
    ]
    tw = twin(*shards)
    tw.j.warmup()
    assert tw.t.warmup() > 0
    assert tw.t._fused_dirty is False
    tw.add_delta(_shard([_rec("1", 123_456)], ds="d0", vcf="v0"))
    assert tw.t._fused_dirty is False
    got, _ = tw.search(_doc(datasets=["d0", "d1", "d2"]))
    assert any("123456" in v for v in _variants(got))
    assert tw.t.fused_searches == 1


# -- the L0 tier ---------------------------------------------------------------


def test_l0_stack_builds_past_threshold_and_serves_tail(twin):
    tw, recs = _deep_tail(twin, l0_min_shards=3, response_cache=False)
    status = tw.t.l0_status()
    assert status["built"] and status["shards"] == 5
    got, ctx = tw.search(_doc())
    assert ctx.cost.delta_shards == 0
    assert tw.t.l0_searches >= 1
    # the tail rode one batched submission against the L0 composite
    assert {"stage": "batch", "decision": "CompositeL0DeviceIndex"} in [
        {k: e[k] for k in ("stage", "decision")} for e in ctx.plan]
    assert ctx.notes["dispatch_l0"] == 5
    mono = twin(_shard(recs), response_cache=False)
    want, _ = mono.search(_doc())
    assert _variants(got) == _variants(want)


@pytest.mark.parametrize("gran", ["boolean", "count", "record"])
@pytest.mark.parametrize("alt", [None, "N", "T", "selected"])
def test_l0_parity_byte_identical_across_shapes(twin, gran, alt):
    on, recs = _deep_tail(twin, rng_seed=61, l0_min_shards=3,
                          response_cache=False)
    off, _ = _deep_tail(twin, rng_seed=61, l0_min_shards=0, l0_min_rows=0,
                        response_cache=False)
    assert on.t.l0_status()["built"] and not off.t.l0_status()["built"]
    if alt == "selected":
        q = _doc(gran=gran, selected_samples_only=True,
                 sample_names={"dsA": ["S0"]}, include_samples=True)
    else:
        q = _doc(gran=gran, alt=alt)
    a, _ = on.search(q)
    b, _ = off.search(q)
    assert _asd(a) == _asd(b)
    if gran != "boolean":
        mono = twin(_shard(recs), response_cache=False)
        rm, _ = mono.search(q)
        assert _variants(a) == _variants(rm)
        assert sum(r.call_count for r in a) == sum(r.call_count for r in rm)


def test_l0_generation_retired_by_fold_and_residue_still_charged(twin):
    tw, _recs = _deep_tail(twin, l0_min_shards=3, response_cache=False)
    assert tw.t.l0_status()["built"]
    pre, _ = tw.search(_doc())
    tw.fold(("dsA", "a.vcf"))
    assert tw.t.delta_stats() == {}
    assert not tw.t.l0_status()["built"]
    post, _ = tw.search(_doc())
    assert _variants(post) == _variants(pre)
    tw.add_delta(_shard([_rec("1", 900_000)]))
    got, ctx = tw.search(_doc())
    assert ctx.cost.delta_shards == 1
    assert any("900000" in v for v in _variants(got))


@pytest.mark.parametrize("l0_shards", [3, 0])
def test_delta_shard_charges_match_shards_actually_host_walked(twin,
                                                               l0_shards):
    recs = random_records(random.Random(62), chrom="1", n=400, n_samples=2)
    tw = twin(
        _shard(recs[:200]),
        _shard(random_records(random.Random(63), chrom="1", n=100,
                              n_samples=2), ds="dsB", vcf="b.vcf"),
        l0_min_shards=l0_shards, l0_min_rows=0 if l0_shards == 0 else 4096,
        response_cache=False,
    )
    for i in range(4):
        tw.add_delta(_shard(recs[200 + 50 * i:250 + 50 * i]))
    tw.add_delta(_shard([_rec("1", 700_001)], ds="dsB", vcf="b.vcf"))
    tw.add_delta(_shard([_rec("1", 700_002)], ds="dsB", vcf="b.vcf"))
    _got, ctx = tw.search(_doc())
    assert ctx.cost.delta_shards == (2 if l0_shards else 6)


def test_l0_past_the_row_threshold(twin):
    """The row trigger alone stacks a shallow tail."""
    recs = random_records(random.Random(64), chrom="1", n=300, n_samples=2)
    tw = twin(_shard(recs[:100]), l0_min_shards=0, l0_min_rows=150,
              response_cache=False)
    tw.add_delta(_shard(recs[100:200]))
    assert not tw.t.l0_status()["built"]
    tw.add_delta(_shard(recs[200:]))
    assert tw.t.l0_status()["built"]
    tw.search(_doc(gran="record"))


def test_mesh_tier_delta_tail_rides_l0(twin):
    shards = [
        _shard(random_records(random.Random(64 + i), chrom="1", n=150,
                              n_samples=2), ds=f"d{i}", vcf=f"v{i}")
        for i in range(3)
    ]
    tw = twin(*shards, l0_min_shards=3, response_cache=False)
    tier = MeshDispatchTier(tw.t, min_shards=2, devices=[CPU] * 2)
    jtier = JTier(tw.j, min_shards=2, devices=jax.devices()[:2])
    try:
        assert tier.warmup() > 0
        assert jtier._ready(wait=True) is not None
        for i in range(4):
            tw.add_delta(_shard([_rec("1", 800_000 + i)], ds="d0", vcf="v0"))
        assert tw.t.l0_status()["built"]
        doc = _doc(datasets=["d0", "d1", "d2"])
        assert tier.resolve(["d0", "d1", "d2"], VariantQueryPayload(**doc))
        served0 = tw.t.l0_searches
        tctx = ttel.RequestContext(route="test")
        with ttel.request_context(tctx):
            got = tier.search(VariantQueryPayload(**doc), {"d0", "d1", "d2"})
        jctx = jtel.RequestContext(route="test")
        with jtel.request_context(jctx):
            want = jtier.search(JPayload(**doc), {"d0", "d1", "d2"})
        assert _asd(got) == _asd(want)
        assert tctx.cost.delta_shards == jctx.cost.delta_shards == 0
        assert tw.t.l0_searches > served0
        assert any("800003" in v for v in _variants(got))
        assert tctx.notes["mesh_tail_l0"] == jctx.notes["mesh_tail_l0"] == 4
        assert ([e for e in tctx.plan if e["stage"] == "mesh"]
                == [e for e in jctx.plan if e["stage"] == "mesh"])
    finally:
        tier.close()
        jtier.close()


def test_publish_burst_on_one_key_leaves_other_keys_l0_untouched(twin):
    recs_a = random_records(random.Random(70), chrom="1", n=400, n_samples=2)
    recs_b = random_records(random.Random(71), chrom="1", n=400, n_samples=2)
    tw = twin(_shard(recs_a[:200]),
              _shard(recs_b[:200], ds="dsB", vcf="b.vcf"),
              l0_min_shards=3, response_cache=False)
    for i in range(4):
        tw.add_delta(_shard(recs_a[200 + 40 * i:240 + 40 * i]))
        tw.add_delta(_shard(recs_b[200 + 40 * i:240 + 40 * i], ds="dsB",
                            vcf="b.vcf"))
    status = tw.t.l0_status()
    assert set(status["keys"]) == {"dsA/a.vcf", "dsB/b.vcf"}
    a_builds = status["keys"]["dsA/a.vcf"]["builds"]
    b_builds = status["keys"]["dsB/b.vcf"]["builds"]
    b_block = tw.t._l0_blocks[("dsB", "b.vcf")][0]
    pre_a, _ = tw.search(_doc(datasets=["dsA"]))
    pre_b, _ = tw.search(_doc(datasets=["dsB"]))
    for i in range(6):
        tw.add_delta(_shard([_rec("1", 500_000 + i)]))
    status = tw.t.l0_status()
    assert status["keys"]["dsA/a.vcf"]["builds"] > a_builds
    assert status["keys"]["dsB/b.vcf"]["builds"] == b_builds
    assert tw.t._l0_blocks[("dsB", "b.vcf")][0] is b_block
    assert status["blockReuses"] > 0
    got_a, _ = tw.search(_doc(datasets=["dsA"]))
    assert any("500005" in v for v in _variants(got_a))
    assert _variants(pre_a) <= _variants(got_a)
    got_b, _ = tw.search(_doc(datasets=["dsB"]))
    assert _variants(got_b) == _variants(pre_b)


def test_replace_delta_range_and_drop_dataset(twin):
    recs = random_records(random.Random(72), chrom="1", n=300, n_samples=2)
    tw = twin(_shard(recs[:100]), _shard([_rec("1", 5)], ds="dsB",
                                         vcf="b.vcf"),
              l0_min_shards=3, response_cache=False)
    for i in range(4):
        tw.add_delta(_shard(recs[100 + 50 * i:150 + 50 * i]))
    key = ("dsA", "a.vcf")
    assert [e for e, _s in tw.t.delta_snapshot(key)[0][2]] == [1, 2, 3, 4]
    (_k, _b, tail), = tw.j.delta_snapshot(key)
    merged = j_merge_shards([tail[1][1], tail[2][1]])
    (_k, _b, ttail), = tw.t.delta_snapshot(key)
    tmerged = merge_shards([ttail[1][1], ttail[2][1]])
    assert tw.j.replace_delta_range(key, [2, 3], merged)
    assert tw.t.replace_delta_range(key, [2, 3], tmerged)
    assert not tw.t.replace_delta_range(key, [2, 3], tmerged)
    tw.same_state()
    assert tw.t.delta_depth(*key) == 3
    tw.search(_doc(gran="record"))
    assert tw.j.drop_dataset("dsA") == tw.t.drop_dataset("dsA") == 1
    assert tw.t.drop_dataset("nope") == 0
    tw.same_state()
    assert tw.t.datasets() == ["dsB"]
    tw.search(_doc(gran="record"))


@pytest.mark.parametrize("sizes", [[1], [5], [8], [9, 3], [17, 1, 8]])
def test_l0_segment_tables_equal_jax(sizes):
    """Each block's padded segment table, shard bases, window hint and
    padded rows, and the composite's shifted table, equal the JAX
    package's."""
    rng = random.Random(sum(sizes))
    blocks_j, blocks_t = [], []
    for k in sizes:
        shards = [
            _shard(random_records(rng, chrom=rng.choice(["1", "2", "X"]),
                                  n=rng.randrange(1, 700), n_samples=2))
            for _ in range(k)
        ]
        jb = JL0DeviceIndex(shards)
        tb = tk.L0DeviceIndex([shard_from_reference(s) for s in shards], CPU)
        np.testing.assert_array_equal(tb.chrom_offsets_host,
                                      jb.chrom_offsets_host)
        np.testing.assert_array_equal(
            tb.chrom_offsets.numpy(), np.asarray(jb.arrays["chrom_offsets"]))
        np.testing.assert_array_equal(tb.shard_base, jb.shard_base)
        assert (tb.window_hint, tb.n_padded, tb.n_shards,
                tb.n_shards_padded) == (jb.window_hint, jb.n_padded,
                                        jb.n_shards, jb.n_shards_padded)
        blocks_j.append(jb)
        blocks_t.append(tb)
    jc, tc = JComposite(blocks_j), tk.CompositeL0DeviceIndex(blocks_t)
    np.testing.assert_array_equal(tc.chrom_offsets.numpy(),
                                  np.asarray(jc.arrays["chrom_offsets"]))
    np.testing.assert_array_equal(tc.shard_base, jc.shard_base)
    assert tc.block_sid_offsets == jc.block_sid_offsets
    assert (tc.window_hint, tc.n_padded, tc.n_shards_padded, tc.n_iters) == (
        jc.window_hint, jc.n_padded, jc.n_shards_padded, jc.n_iters)
    for name in ("pos", "rec_end", "ac", "rec_id"):
        np.testing.assert_array_equal(tc.arrays[name].numpy(),
                                      np.asarray(jc.arrays[name]))
    assert tc.flight_family == jc.flight_family == "fused_l0"


# -- failures raise ------------------------------------------------------------


def test_failed_l0_build_raises_on_publish_and_request(monkeypatch):
    """No host walk hides a failed L0 build: the publish that triggered
    it raises (its rows are published), every request that reads the
    tail raises until a rebuild succeeds; a request without tail
    targets is served."""
    recs = random_records(random.Random(73), chrom="1", n=300, n_samples=2)
    eng = VariantEngine(BeaconConfig(engine=EngineConfig(
        use_mesh=False, l0_min_shards=3, response_cache=False)),
        device="cpu")
    try:
        eng.add_index(shard_from_reference(_shard(recs[:100])))
        eng.add_index(shard_from_reference(_shard([_rec("2", 5)], ds="dsB",
                                                  vcf="b.vcf")))
        for i in range(2):
            eng.add_delta(shard_from_reference(
                _shard(recs[100 + 50 * i:150 + 50 * i])))

        def boom(*_a, **_k):
            raise MemoryError("device out of memory")

        monkeypatch.setattr(t_engine, "L0DeviceIndex", boom)
        with pytest.raises(MemoryError):
            eng.add_delta(shard_from_reference(_shard(recs[200:250])))
        assert eng.delta_depth("dsA", "a.vcf") == 3
        with pytest.raises(RuntimeError, match="L0 index failed") as ei:
            eng.search(VariantQueryPayload(**_doc()))
        assert isinstance(ei.value.__cause__, MemoryError)
        assert eng.search(VariantQueryPayload(**_doc(chrom="2",
                                                     datasets=["dsB"])))
        monkeypatch.undo()
        eng.add_delta(shard_from_reference(_shard(recs[250:])))
        assert eng.l0_status()["built"]
        got = eng.search(VariantQueryPayload(**_doc()))
        assert len(_variants(got)) > 0
    finally:
        eng.close()


@pytest.mark.parametrize("microbatch", [True, False])
def test_failed_l0_launch_raises_on_the_request(microbatch):
    recs = random_records(random.Random(74), chrom="1", n=300, n_samples=2)
    eng = VariantEngine(BeaconConfig(engine=EngineConfig(
        use_mesh=False, l0_min_shards=3, response_cache=False,
        microbatch=microbatch)), device="cpu")
    try:
        eng.add_index(shard_from_reference(_shard(recs[:100])))
        for i in range(4):
            eng.add_delta(shard_from_reference(
                _shard(recs[100 + 50 * i:150 + 50 * i])))
        faults.install({"rules": [{"site": "kernel.launch",
                                   "kind": "error"}]})
        try:
            with pytest.raises(faults.FaultError):
                eng.l0_pre_rows(
                    [(k, s) for k, s in eng._l0_state[2].items()],
                    tk.QuerySpec("1", 1, 1 << 29, 1, 1 << 30,
                                 alternate_bases="N"),
                    VariantQueryPayload(**_doc()),
                )
        finally:
            faults.uninstall()
    finally:
        eng.close()


def test_journal_records_the_tail_as_jax(twin):
    """The publishes and L0 builds journal the same kinds and data in
    both packages."""
    jseq = jtel.journal.last_seq()
    tseq = ttel.journal.events()[-1]["seq"] if ttel.journal.events() else 0
    tw, _recs = _deep_tail(twin, l0_min_shards=3, response_cache=False)
    tw.fold(("dsA", "a.vcf"))
    assert tw.j.drop_dataset("dsA") == tw.t.drop_dataset("dsA") == 1

    def kinds(evs):
        return [(e["kind"], e.get("data")) for e in evs
                if e["kind"].startswith("ingest.")]

    got = kinds(ttel.journal.events(since=tseq, kind="ingest"))
    want = kinds(jtel.journal.events(since=jseq, kind="ingest"))
    assert got == want
    assert [k for k, _d in got].count("ingest.l0_build") == 3
