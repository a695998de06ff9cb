"""The port's response cache against the JAX package's.

Each case feeds the same seeded shards and the same sequence of
publishes and searches to a JAX engine and a port engine (``device=
"cpu"``: the kernels run their plain-PyTorch twins) and compares, at
tolerance 0, ``dataclasses.asdict`` of every response, the cache's
counters after every step, the cache keys and the fingerprints. The
cases are those of ``tests/test_response_cache.py`` and the scoped
invalidation cases of ``tests/test_delta_ingest.py``.
"""

import dataclasses
import random
import time

import pytest

from sbeacon_tpu.config import BeaconConfig as JBeaconConfig
from sbeacon_tpu.config import EngineConfig as JEngineConfig
from sbeacon_tpu.engine import VariantEngine as JVariantEngine
from sbeacon_tpu.genomics.vcf import VcfRecord
from sbeacon_tpu.index.columnar import build_index as j_build_index
from sbeacon_tpu.payloads import VariantQueryPayload as JPayload
from sbeacon_tpu.response_cache import ResponseCache as JResponseCache
from sbeacon_tpu.response_cache import response_cache_key as j_cache_key
from sbeacon_tpu.response_cache import response_cache_scope as j_cache_scope
from sbeacon_tpu.telemetry import MetricsRegistry as JMetricsRegistry
from sbeacon_tpu.testing import random_records
from sbeacon_tpu_torch.config import BeaconConfig, EngineConfig
from sbeacon_tpu_torch.engine import VariantEngine
from sbeacon_tpu_torch.index import shard_from_reference
from sbeacon_tpu_torch.payloads import VariantQueryPayload
from sbeacon_tpu_torch.response_cache import (
    ResponseCache,
    copy_response,
    response_cache_key,
    response_cache_scope,
)
from sbeacon_tpu_torch.telemetry import MetricsRegistry
from torch_ingest_corpus import no_thread_leak  # noqa: F401

SAMPLES = ["S0", "S1"]


def _rec(chrom, pos, ref="A", alt="T"):
    return VcfRecord(chrom=chrom, pos=pos, ref=ref, alts=[alt], ac=[1],
                     an=4, vt="SNP", genotypes=["0|1", "0|0"])


def _random_shard(seed, ds):
    recs = random_records(random.Random(seed), chrom="1", n=200, n_samples=2)
    return j_build_index(recs, dataset_id=ds, vcf_location=f"{ds}.vcf",
                         sample_names=SAMPLES)


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


class Twin:
    """A JAX engine and a port engine fed the same publishes; every
    search and counter is compared at tolerance 0."""

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
        return epoch

    def search(self, doc):
        want = self.j.search(JPayload(**doc))
        got = self.t.search(VariantQueryPayload(**doc))
        assert _asd(got) == _asd(want), doc
        assert self.t.cache_stats() == self.j.cache_stats(), doc
        return got

    def close(self):
        self.j.close()
        self.t.close()


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


def test_config_defaults_as_jax():
    t, j = EngineConfig(), JEngineConfig()
    for name in ("response_cache", "response_cache_size",
                 "response_cache_ttl_s", "scoped_invalidation",
                 "l0_min_shards", "l0_min_rows"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.response_cache is True


def test_ingest_invalidates_cached_query(twin):
    tw = twin(_random_shard(1, "dsA"))
    doc = _doc()
    assert [r.dataset_id for r in tw.search(doc)] == ["dsA"]
    tw.search(doc)
    assert tw.t.cache_stats()["hits"] == 1
    fp = tw.t.index_fingerprint()
    assert fp == tw.j.index_fingerprint()
    tw.add_index(_random_shard(2, "dsB"))
    assert tw.t.index_fingerprint() == tw.j.index_fingerprint() != fp
    assert tw.t.cache_stats()["invalidations"] >= 1
    assert sorted(r.dataset_id for r in tw.search(doc)) == ["dsA", "dsB"]


def test_negative_result_cached_and_served_without_dispatch(twin):
    tw = twin(_random_shard(3, "dsA"))
    doc = _doc(lo=1 << 28, hi=(1 << 28) + 10)
    assert not any(r.exists for r in tw.search(doc))
    submits = tw.t.batcher.occupancy()["submits"]
    assert not any(r.exists for r in tw.search(doc))
    assert tw.t.batcher.occupancy()["submits"] == submits  # no launch
    stats = tw.t.cache_stats()
    assert stats["hits"] == 1 and stats["negative_hits"] == 1


def test_served_responses_are_copy_isolated(twin):
    tw = twin(_random_shard(4, "dsA"))
    doc = _doc()
    first = tw.search(doc)
    first[0].variants.append("CORRUPTED")
    first[0].sample_names.append("EVE")
    again = tw.search(doc)
    assert "CORRUPTED" not in again[0].variants
    assert "EVE" not in again[0].sample_names
    clone = copy_response(again[0])
    clone.variants.append("X")
    assert "X" not in again[0].variants


@pytest.mark.parametrize("over", [
    {}, {"alternate_bases": "acGT"}, {"alternate_bases": "ACGT"},
    {"reference_bases": "tg"}, {"dataset_ids": ["dsB", "dsA"]},
    {"requested_granularity": "boolean"}, {"include_samples": True},
    {"selected_samples_only": True,
     "sample_names": {"dsB": ["S1", "S0"], "dsA": ["S0"]}},
    {"variant_type": "DEL", "alternate_bases": None},
])
def test_cache_keys_and_scopes_equal_jax(twin, over):
    """The key embeds ``cache_fingerprint``: the port's is the JAX
    engine's string for every dataset set, so the keys are equal."""
    tw = twin(_random_shard(6, "dsA"), _random_shard(7, "dsB"))
    doc = {**_doc(), **over}
    for ds in ([], ["dsA"], ["dsB", "dsA"], ["nope"]):
        assert tw.t.cache_fingerprint(ds) == tw.j.cache_fingerprint(ds)
    fp = tw.t.cache_fingerprint(doc["dataset_ids"])
    key = response_cache_key(fp, VariantQueryPayload(**doc))
    assert key == j_cache_key(fp, JPayload(**doc))
    assert (response_cache_scope(VariantQueryPayload(**doc))
            == j_cache_scope(JPayload(**doc)))
    assert tw.t.dataset_fingerprints() == tw.j.dataset_fingerprints()
    assert tw.t.base_fingerprint() == tw.j.base_fingerprint()
    tw.search(doc)
    tw.search(doc)


def test_key_normalization_and_shaping_fields():
    pay = lambda **o: VariantQueryPayload(**{**_doc(), **o})
    fp = "fp1"
    a = response_cache_key(fp, pay(alternate_bases="acGT"))
    assert a == response_cache_key(fp, pay(alternate_bases="ACGT"))
    assert (response_cache_key(fp, pay(dataset_ids=["d2", "d1"]))
            == response_cache_key(fp, pay(dataset_ids=["d1", "d2"])))
    assert response_cache_key(fp, pay(requested_granularity="boolean")) != a
    assert response_cache_key("fp2", pay()) != response_cache_key(fp, pay())


def _cache_ops(cache_cls, sleep_s):
    cache = cache_cls(max_entries=2, ttl_s=sleep_s)
    cache.put(("k1",), [])
    cache.put(("k2",), [])
    cache.put(("k3",), [])  # evicts k1
    got = [cache.get(("k1",)) is None, cache.get(("k2",)) is not None]
    time.sleep(sleep_s * 1.5)
    got.append(cache.get(("k2",)) is None)  # expired
    stats = cache.stats()
    stats.pop("hit_rate")
    return got, stats


def test_lru_eviction_and_ttl():
    got, stats = _cache_ops(ResponseCache, 0.05)
    assert got == [True, True, True]
    assert stats["evictions"] == 1 and stats["expirations"] == 1
    assert (got, stats) == _cache_ops(JResponseCache, 0.05)


def test_cache_disabled_by_config(twin):
    tw = twin(_random_shard(5, "dsA"), response_cache=False)
    assert tw.t.cache_stats() is None
    submits = tw.t.batcher.occupancy()["submits"]
    tw.search(_doc())
    tw.search(_doc())
    assert tw.t.batcher.occupancy()["submits"] - submits == 2


def test_no_response_cache_bypasses(twin):
    tw = twin(_random_shard(5, "dsA"))
    doc = _doc(no_response_cache=True)
    tw.search(doc)
    tw.search(doc)
    assert tw.t.cache_stats()["entries"] == 0
    assert tw.t.cache_stats()["misses"] == 0


def test_ttl_zero_means_no_expiry():
    cache = ResponseCache(max_entries=8, ttl_s=0)
    cache.put(("k",), [])
    time.sleep(0.02)
    assert cache.get(("k",)) is not None


# -- scoped invalidation by delta publishes ---------------------------------


def test_negative_cache_evicted_by_overlapping_delta(twin):
    tw = twin(_shard([_rec("1", 1000)]))
    neg = _doc(chrom="1", lo=5000, hi=6000)
    assert not any(r.exists for r in tw.search(neg))
    assert not any(r.exists for r in tw.search(neg))
    assert tw.t.cache_stats()["negative_hits"] == 1
    tw.add_delta(_shard([_rec("1", 5500)]))
    assert any(r.exists for r in tw.search(neg))


def test_nonoverlapping_entries_survive_delta_publish(twin):
    tw = twin(_shard([_rec("1", 1000), _rec("2", 1000)], ds="dsA"),
              _shard([_rec("1", 1000)], ds="dsB", vcf="b.vcf"))
    q_far = _doc(chrom="1", lo=900, hi=1100, datasets=["dsA"])
    q_chr2 = _doc(chrom="2", lo=900, hi=1100, datasets=["dsA"])
    q_dsB = _doc(chrom="1", datasets=["dsB"])
    for q in (q_far, q_chr2, q_dsB):
        tw.search(q)
    hits0 = tw.t.cache_stats()["hits"]
    tw.add_delta(_shard([_rec("1", 500_000)], ds="dsA"))
    for q in (q_chr2, q_dsB, q_far):
        tw.search(q)
    assert tw.t.cache_stats()["hits"] == hits0 + 3
    got = tw.search(_doc(chrom="1", lo=400_000, hi=600_000,
                         datasets=["dsA"]))
    assert any("500000" in v for r in got for v in r.variants)


def test_all_dataset_entries_scope_evicted_by_region(twin):
    tw = twin(_shard([_rec("1", 1000)]))
    tw.search(_doc(chrom="2"))
    hits0 = tw.t.cache_stats()["hits"]
    tw.add_delta(_shard([_rec("1", 2000)]))
    tw.search(_doc(chrom="2"))
    assert tw.t.cache_stats()["hits"] == hits0 + 1
    got = tw.search(_doc(chrom="1"))
    assert any("2000" in v for r in got for v in r.variants)


def test_scoped_invalidation_toggle_off_restores_wholesale_clear(twin):
    tw = twin(_shard([_rec("1", 1000)]), scoped_invalidation=False)
    tw.search(_doc(chrom="2"))
    assert tw.t.cache_stats()["entries"] == 1
    tw.add_delta(_shard([_rec("1", 9000)]))
    stats = tw.t.cache_stats()
    assert stats == tw.j.cache_stats()
    assert stats["entries"] == 0 and stats["scoped_invalidations"] == 0


@pytest.mark.parametrize("cache_cls", [ResponseCache, JResponseCache])
def test_put_race_guard_refuses_stale_store(cache_cls):
    cache = cache_cls()
    gen = cache.generation()
    cache.invalidate_scope(["dsA"], "1", (100, 200))
    scope_overlap = (frozenset({"dsA"}), "1", (150, 250))
    scope_clear = (frozenset({"dsB"}), "2", (1, 50))
    assert cache.put(("k1",), [], scope=scope_overlap, gen=gen) is False
    assert cache.put(("k2",), [], scope=scope_clear, gen=gen) is True
    assert cache.put(("k3",), [], scope=scope_overlap) is True


def test_publish_mid_search_is_not_outrun_by_a_stale_put(twin,
                                                        monkeypatch):
    """A delta publish landing while a search runs: the search's put
    carries the generation captured before dispatch, so its stale
    answer is refused and the next search sees the new row."""
    tw = twin(_shard([_rec("1", 1000)]))
    doc = _doc(chrom="1", lo=1, hi=10_000)
    orig = tw.t._search

    def racing(payload, sp=None):
        out = orig(payload, sp)
        tw.t.add_delta(shard_from_reference(_shard([_rec("1", 4000)])))
        return out

    monkeypatch.setattr(tw.t, "_search", racing)
    stale = tw.t.search(VariantQueryPayload(**doc))
    monkeypatch.undo()
    assert not any("4000" in v for r in stale for v in r.variants)
    assert tw.t.cache_stats()["entries"] == 0
    fresh = tw.t.search(VariantQueryPayload(**doc))
    assert any("4000" in v for r in fresh for v in r.variants)


def test_cache_and_delta_metrics_render_as_jax(twin):
    tw = twin(_shard([_rec("1", 1000)]))
    tw.search(_doc())
    tw.search(_doc())
    tw.add_delta(_shard([_rec("1", 2000)]))
    tw.search(_doc())
    regs = []
    for eng, reg in ((tw.j, JMetricsRegistry()), (tw.t, MetricsRegistry())):
        eng.register_metrics(reg)
        regs.append(reg)
    jr, tr = regs
    # the batcher's fetch stage registers its fetcher pool and fetch
    # quantiles under JAX's names
    assert set(tr.names()) == set(jr.names())
    assert {"batcher.fetcher.threads", "batcher.fetcher.queued",
            "batcher.fetch_ms"} <= set(tr.names())
    jj, tj = jr.render_json(), tr.render_json()
    assert tj["response_cache"] == jj["response_cache"]
    assert tj["ingest"] == jj["ingest"]
    assert tj["engine"]["fused_searches"] == jj["engine"]["fused_searches"]
