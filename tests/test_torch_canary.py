"""The port's canary prober against the JAX package's, at tolerance 0.

A JAX engine and a port engine (``device="cpu"``: the kernel wrappers
run their plain-PyTorch twins) are fed the same seeded shards and delta
publishes (carried over by ``shard_from_reference``); their
``canary_brackets`` (the known-hit row of the newest serving shard with
a plain allele, the coordinate ceiling), the probe set
(``_probes_for``) and each ``run_once`` round's verdicts, the prober's
status and series and the plan shapes it folds are compared after every
step. A probe whose search raises counts as a failure, never as an
answer. Neither prober starts a thread (``interval_s=0``).
"""

import dataclasses
import random
import time

import pytest

import sbeacon_tpu.canary as jcanary
import sbeacon_tpu.plan as jplan
import sbeacon_tpu.telemetry as jtel
import sbeacon_tpu_torch.canary as tcanary
import sbeacon_tpu_torch.plan as tplan
import sbeacon_tpu_torch.telemetry as ttel
from sbeacon_tpu.config import BeaconConfig as JBeaconConfig
from sbeacon_tpu.config import EngineConfig as JEngineConfig
from sbeacon_tpu.engine import VariantEngine as JVariantEngine
from sbeacon_tpu.genomics.vcf import VcfRecord
from sbeacon_tpu.index.columnar import build_index as j_build_index
from sbeacon_tpu.testing import random_records
from sbeacon_tpu_torch.config import BeaconConfig, EngineConfig
from sbeacon_tpu_torch.engine import VariantEngine
from sbeacon_tpu_torch.index import shard_from_reference
from torch_ingest_corpus import no_thread_leak  # noqa: F401

SAMPLES = ["S0", "S1"]


def _shard(seed, ds, vcf, chrom="1", n=150):
    recs = random_records(random.Random(seed), chrom=chrom, n=n,
                          n_samples=2)
    return j_build_index(recs, dataset_id=ds, vcf_location=vcf,
                         sample_names=SAMPLES)


def _symbolic_shard(ds, vcf):
    recs = [VcfRecord(chrom="2", pos=100 + 10 * i, ref="A",
                      alts=["<DEL>"], ac=[1], an=4, vt="SV",
                      genotypes=["0|1", "0|0"]) for i in range(5)]
    return j_build_index(recs, dataset_id=ds, vcf_location=vcf,
                         sample_names=SAMPLES)


class Pair:
    def __init__(self):
        self.j = JVariantEngine(JBeaconConfig(engine=JEngineConfig(
            use_mesh=False, l0_min_shards=2)))
        self.t = VariantEngine(BeaconConfig(engine=EngineConfig(
            use_mesh=False, l0_min_shards=2)), device="cpu")
        self.clk = [100.0]
        clock = lambda: self.clk[0]  # noqa: E731
        self.jstore = jplan.PlanStore(window_s=0, clock=clock)
        self.tstore = tplan.PlanStore(window_s=0, clock=clock)
        self.jp = jcanary.CanaryProber(self.j, interval_s=0, clock=clock,
                                       plan_store=self.jstore,
                                       latency_ms=1e9)
        self.tp = tcanary.CanaryProber(self.t, interval_s=0, clock=clock,
                                       plan_store=self.tstore,
                                       latency_ms=1e9)

    def add_index(self, shard):
        self.j.add_index(shard)
        self.t.add_index(shard_from_reference(shard))

    def add_delta(self, shard):
        assert self.t.add_delta(shard_from_reference(shard)) == (
            self.j.add_delta(shard))

    def compare(self):
        jb, tb = self.j.canary_brackets(), self.t.canary_brackets()
        assert tb == jb
        for ds, bracket in sorted(tb.items()):
            got = [dataclasses.asdict(p)
                   for p in tcanary._probes_for(ds, bracket)]
            want = [dataclasses.asdict(p)
                    for p in jcanary._probes_for(ds, bracket)]
            assert got == want
        self.clk[0] += 7.0
        got, want = self.tp.run_once(), self.jp.run_once()
        assert got == want
        assert self.tp.status() == self.jp.status()
        assert self.tp.counters() == self.jp.counters()
        # the probes' plans, folded under canary:<shape>:<path>
        tsnap, jsnap = self.tstore.snapshot(), self.jstore.snapshot()
        assert sorted(tsnap["shapes"]) == sorted(jsnap["shapes"])
        for q, doc in tsnap["shapes"].items():
            assert ({p: v["count"] for p, v in doc["plans"].items()}
                    == {p: v["count"] for p, v in
                        jsnap["shapes"][q]["plans"].items()})
        return got

    def close(self):
        self.jp.close()
        self.tp.close()
        self.j.close()
        self.t.close()


@pytest.fixture
def pair():
    p = Pair()
    yield p
    p.close()


def test_rounds_equal_across_publishes(pair):
    assert pair.compare()["registered"] == 0  # nothing loaded yet
    pair.add_index(_shard(1, "dsA", "a.vcf"))
    pair.add_index(_shard(2, "dsB", "b.vcf", chrom="X"))
    pair.add_index(_symbolic_shard("dsC", "c.vcf"))
    first = pair.compare()
    assert first["registered"] == 5  # dsC has no plain row: miss only
    assert first["mismatches"] == first["failures"] == 0
    assert first["probes"] == 5 * 2
    # a delta publish re-registers: the hit probe moves to its rows
    for k in range(3):
        pair.add_delta(_shard(10 + k, "dsA", "a.vcf", n=20))
        got = pair.compare()
        assert got["mismatches"] == 0
    assert pair.t.l0_status()["built"]
    # unchanged fingerprint: the probe set is kept
    assert pair.tp.sync_probes() == pair.jp.sync_probes()
    reg_t, reg_j = ttel.MetricsRegistry(), jtel.MetricsRegistry()
    pair.tp.register_metrics(reg_t)
    pair.jp.register_metrics(reg_j)
    assert reg_t.render_json() == reg_j.render_json()


def test_a_failing_search_is_a_failure_not_an_answer(pair):
    pair.add_index(_shard(3, "dsA", "a.vcf"))

    def broken(payload):
        raise RuntimeError("launch refused")

    pair.t.search = broken
    pair.j.search = broken
    seq_t, seq_j = ttel.journal.last_seq(), jtel.journal.last_seq()
    got = pair.compare()
    assert got["failures"] == got["probes"] == 4 and got["mismatches"] == 0
    assert ([e["data"] for e in ttel.journal.events(
        since=seq_t, kind="canary.failure")]
        == [e["data"] for e in jtel.journal.events(
            since=seq_j, kind="canary.failure")])


def test_probes_stay_out_of_the_response_cache(pair):
    pair.add_index(_shard(4, "dsA", "a.vcf"))
    pair.compare()
    pair.compare()
    assert pair.t.cache_stats() == pair.j.cache_stats()
    assert pair.t.cache_stats()["hits"] == 0


def test_thread_runs_rounds_and_closes():
    eng = VariantEngine(BeaconConfig(engine=EngineConfig(use_mesh=False)),
                        device="cpu")
    try:
        eng.add_index(shard_from_reference(_shard(5, "dsA", "a.vcf")))
        prober = tcanary.CanaryProber(eng, interval_s=0.02)
        prober.start()
        for _ in range(200):
            if prober.status()["runs"] >= 2:
                break
            time.sleep(0.01)
        prober.close()
        assert prober.status()["runs"] >= 2
        assert prober.counters()["mismatches"] == 0
    finally:
        eng.close()
