"""The port's delta compactor against the JAX package's, at tolerance 0.

A JAX engine and a port engine (``device="cpu"``) are fed the same base
shard and delta publishes, each with its own compactor over its own data
root, and the same folds run on both: ``run_once`` under the legacy and
the size-tiered policies (L1 artifacts, the base merge on the byte
ratio), the depth trigger of ``notify``, the ``compaction.fold`` fault
site at each of its four seams, and retention GC. Every step compares
the folded rows, the compactor's counters, the delta registry, the
ledger's fold records and every search response. Then the port's own
repair (the per-key publish lock): a base fold whose snapshot predates a
summarisation's final publish no longer undoes it, and the background
thread folding while a VCF streams leaves every row served.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time

import pytest

from sbeacon_tpu.config import BeaconConfig as JBeaconConfig
from sbeacon_tpu.config import EngineConfig as JEngineConfig
from sbeacon_tpu.config import IngestConfig as JIngestConfig
from sbeacon_tpu.config import StorageConfig as JStorageConfig
from sbeacon_tpu.engine import VariantEngine as JVariantEngine
from sbeacon_tpu.genomics.tabix import ensure_index as j_ensure_index
from sbeacon_tpu.genomics.vcf import VcfRecord
from sbeacon_tpu.harness import faults as jfaults
from sbeacon_tpu.index.columnar import build_index as j_build_index
from sbeacon_tpu.ingest.ledger import JobLedger as JJobLedger
from sbeacon_tpu.ingest.pipeline import SummarisationPipeline as JPipeline
from sbeacon_tpu.ingest.service import DeltaCompactor as JCompactor
from sbeacon_tpu.ingest.service import IngestService as JIngestService
from sbeacon_tpu.ingest.service import (
    register_compaction_metrics as j_register_compaction_metrics,
)
from sbeacon_tpu.payloads import VariantQueryPayload as JPayload
from sbeacon_tpu.telemetry import MetricsRegistry as JRegistry
from sbeacon_tpu.testing import make_test_vcf as j_make_test_vcf
from sbeacon_tpu.testing import random_records
from sbeacon_tpu_torch.config import (
    BeaconConfig,
    EngineConfig,
    IngestConfig,
    StorageConfig,
)
from sbeacon_tpu_torch.engine import VariantEngine
from sbeacon_tpu_torch.harness import faults as tfaults
from sbeacon_tpu_torch.index.columnar import build_index, load_index
from sbeacon_tpu_torch.index.columnar import shard_from_reference
from sbeacon_tpu_torch.ingest.ledger import JobLedger
from sbeacon_tpu_torch.ingest.pipeline import (
    SummarisationPipeline,
    distinct_variant_count,
)
from sbeacon_tpu_torch.ingest.service import (
    DeltaCompactor,
    IngestService,
    register_compaction_metrics,
)
from sbeacon_tpu_torch.payloads import VariantQueryPayload
from sbeacon_tpu_torch.telemetry import MetricsRegistry
from torch_ingest_corpus import (  # noqa: F401
    assert_shards_equal,
    close_service,
    no_thread_leak,
)

SAMPLES = ["S0", "S1"]


def _rec(chrom, pos, ref="A", alt="T"):
    return VcfRecord(chrom=chrom, pos=pos, ref=ref, alts=[alt], ac=[1],
                     an=4, vt="SNP", genotypes=["0|1", "0|0"])


def _shard(records, ds="dsA", vcf="a.vcf"):
    return j_build_index(records, dataset_id=ds, vcf_location=vcf,
                         sample_names=SAMPLES)


def _q(chrom="1", gran="count"):
    return dict(dataset_ids=[], reference_name=chrom, start_min=1,
                start_max=1 << 29, end_min=1, end_max=(1 << 29) + 64,
                alternate_bases="N", requested_granularity=gran,
                include_datasets="HIT")


def _log(comp):
    return [{k: v for k, v in r.items() if k != "completedAt"}
            for r in comp.pipeline.ledger.compaction_log()]


def _metrics(comp):
    return comp.metrics()


class Twin:
    """A JAX and a port engine fed the same publishes, each with a
    compactor over its own root; every operation runs on both."""

    def __init__(self, tmp_path, bases, engine=None, **ingest):
        engine = dict(use_mesh=False, **(engine or {}))
        ingest.setdefault("compact_interval_s", 0.0)
        self.j = JVariantEngine(JBeaconConfig(engine=JEngineConfig(**engine)))
        self.t = VariantEngine(BeaconConfig(engine=EngineConfig(**engine)),
                               device="cpu")
        for s in bases:
            self.j.add_index(s)
            self.t.add_index(shard_from_reference(s))
        jcfg = JBeaconConfig(storage=JStorageConfig(root=tmp_path / "j"),
                             ingest=JIngestConfig(**ingest))
        tcfg = BeaconConfig(storage=StorageConfig(root=tmp_path / "t"),
                            ingest=IngestConfig(**ingest))
        jcfg.storage.ensure()
        tcfg.storage.ensure()
        jpipe = JPipeline(jcfg, ledger=JJobLedger(), engine=self.j)
        tpipe = SummarisationPipeline(tcfg, ledger=JobLedger(),
                                      engine=self.t)
        self.jc = JCompactor(self.j, jpipe, jpipe.ledger, jcfg)
        self.tc = DeltaCompactor(self.t, tpipe, tpipe.ledger, tcfg)

    def add_delta(self, shard):
        e = self.j.add_delta(shard)
        assert self.t.add_delta(shard_from_reference(shard)) == e
        return e

    def both(self, fn):
        a, b = fn(self.tc), fn(self.jc)
        assert a == b
        return a

    def same(self, chroms=("1",)):
        assert self.t.delta_stats() == self.j.delta_stats()
        assert _metrics(self.tc) == _metrics(self.jc)
        assert _log(self.tc) == _log(self.jc)
        for c in chroms:
            for gran in ("boolean", "count", "record"):
                a = self.t.search(VariantQueryPayload(**_q(c, gran)))
                b = self.j.search(JPayload(**_q(c, gran)))
                assert [dataclasses.asdict(r) for r in a] == [
                    dataclasses.asdict(r) for r in b]

    def close(self):
        for comp in (self.tc, self.jc):
            comp.close()
            comp.pipeline.ledger.close()
        self.j.close()
        self.t.close()


@pytest.mark.parametrize("ratio,l0", [(0.0, 4), (0.35, 4), (0.5, 3),
                                      (10.0, 3)])
def test_run_once_folds_equal(tmp_path, ratio, l0):
    recs = random_records(random.Random(66), chrom="1", n=900, n_samples=2)
    tw = Twin(tmp_path, [_shard(recs[:500])], engine={"l0_min_shards": l0},
              compact_base_ratio=ratio, artifact_retain=1)
    try:
        for i in range(4):
            tw.add_delta(_shard(recs[500 + 50 * i:550 + 50 * i]))
        tw.same()
        tw.both(lambda c: c.run_once())
        tw.same()
        for i in range(4):
            tw.add_delta(_shard(recs[700 + 50 * i:750 + 50 * i]))
        tw.both(lambda c: c.run_once())
        tw.same()
        tw.both(lambda c: c.run_once())  # a quiet key: nothing to fold
        tw.same()
        tw.both(lambda c: sorted(
            p.name for p in c.pipeline.l1_dir("dsA", "a.vcf").glob("*.npz")))
        base = tw.both(lambda c: c.pipeline.shard_path("dsA",
                                                       "a.vcf").exists())
        if base:
            tw.both(lambda c: load_index(c.pipeline.shard_path(
                "dsA", "a.vcf")).meta)
    finally:
        tw.close()


@pytest.mark.parametrize("seam", [":merge", ":publish", ":l1:merge",
                                  ":l1:publish"])
def test_crash_at_each_seam_equal(tmp_path, seam):
    recs = random_records(random.Random(67), chrom="1", n=400, n_samples=2)
    ratio = 10.0 if ":l1" in seam else 0.0
    tw = Twin(tmp_path, [_shard(recs[:300])], engine={"l0_min_shards": 3},
              compact_base_ratio=ratio)
    try:
        for i in range(3):
            tw.add_delta(_shard(recs[300 + 33 * i:333 + 33 * i]))
        plan = {"seed": 7, "rules": [{"site": "compaction.fold",
                                      "kind": "error", "rate": 1.0,
                                      "count": 1, "match": seam}]}
        for mod, comp in ((tfaults, tw.tc), (jfaults, tw.jc)):
            mod.install(plan)
            try:
                assert comp.run_once() == {}
            finally:
                mod.uninstall()
        tw.same()
        assert _metrics(tw.tc)["failures"] == 1
        tw.both(lambda c: c.run_once())
        tw.same()
    finally:
        tw.close()


def test_notify_folds_only_the_tripping_key(tmp_path):
    recs = random_records(random.Random(65), chrom="1", n=300, n_samples=2)
    tw = Twin(tmp_path, [_shard(recs[:100]),
                         _shard(recs[100:200], ds="dsB", vcf="b.vcf")],
              delta_max_shards=2)
    try:
        for i in range(3):
            tw.add_delta(_shard([_rec("1", 10_000 + i)]))
            tw.add_delta(_shard([_rec("1", 20_000 + i)], ds="dsB",
                                vcf="b.vcf"))
        tw.both(lambda c: c.notify("dsA", "a.vcf",
                                   c.engine.delta_depth("dsA", "a.vcf")))
        tw.same()
        assert tw.t.delta_stats()["dsB"]["shards"] == 3
        assert _metrics(tw.tc)["tier_folds"] == {"l1": 1}
        tw.both(lambda c: c.notify("dsB", "b.vcf", 1))  # below the depth
        tw.same()
    finally:
        tw.close()


def test_gc_reclaims_superseded_equal(tmp_path):
    recs = random_records(random.Random(69), chrom="1", n=600, n_samples=2)
    tw = Twin(tmp_path, [_shard(recs[:300])], compact_base_ratio=0.01,
              artifact_retain=1)
    try:
        for round_ in range(3):
            lo = 300 + 100 * round_
            tw.add_delta(_shard(recs[lo:lo + 50]))
            tw.add_delta(_shard(recs[lo + 50:lo + 100]))
            tw.both(lambda c: c.run_once())
            tw.same()
            assert tw.tc.pipeline.shard_path("dsA", "a.vcf").exists()
        m = _metrics(tw.tc)
        assert m["tier_folds"]["base"] == 3 and m["gc_bytes"] > 0
        tw.both(lambda c: len({p.name.split("-", 1)[0] for p in c.pipeline
                               .retired_dir("dsA", "a.vcf").glob("*.npz")}))
        stats = tw.tc.stats()
        jstats = tw.jc.stats()
        for s in (stats, jstats):
            s.pop("l0", None)
        assert stats == jstats and stats["running"] is False
    finally:
        tw.close()


def test_compaction_metrics_catalogue_equal():
    a, b = MetricsRegistry(), JRegistry()
    register_compaction_metrics(a, lambda: {})
    j_register_compaction_metrics(b, lambda: {})
    assert a.names() == b.names()
    assert a.render_json() == b.render_json()


#: a slice per chromosome at least (slices never span contigs)
CHROMS = ("1", "2", "3", "4", "5", "6")


def _streaming_vcf(tmp_path, n=150, n_samples=3):
    path = tmp_path / "vcfs" / "s.vcf.gz"
    path.parent.mkdir(exist_ok=True)
    recs = j_make_test_vcf(path, seed=21, chroms=CHROMS, n_per_chrom=n,
                           n_samples=n_samples)
    j_ensure_index(path)
    return path, recs


#: many slices out of a small VCF
SLICED = dict(min_task_time=1e-9, scan_rate=1e4, dispatch_cost=1e-10,
              max_concurrency=1000)


def _rows(eng, payload_cls):
    """(call count, distinct variants) served over every chromosome."""
    calls, variants = 0, set()
    for c in CHROMS:
        got = eng.search(payload_cls(**_q(c, "record")))
        calls += sum(r.call_count for r in got)
        variants |= {v for r in got for v in r.variants}
    return calls, len(variants)


def test_stale_base_fold_never_undoes_a_final_publish(tmp_path,
                                                     monkeypatch):
    """A compactor base fold that starts while a VCF streams and merges
    slowly, so the summarisation's final save and publish land while it
    runs. The port's fold holds the key's publish lock from its
    snapshot to its publish: the final save waits, then supersedes it,
    and every row stays served and on disk. The JAX package's fold
    overwrites the full artifact and republishes its partial base: the
    rows streamed after its snapshot stop being served (ROADMAP
    Queue 3)."""
    import sbeacon_tpu.ingest.service as jsvc_mod
    import sbeacon_tpu_torch.ingest.service as tsvc_mod

    path, _recs = _streaming_vcf(tmp_path)
    out = {}
    for tag, mod, Eng, Cfg, ECfg, ICfg, SCfg, Svc, P, load in (
        ("t", tsvc_mod, VariantEngine, BeaconConfig, EngineConfig,
         IngestConfig, StorageConfig, IngestService, VariantQueryPayload,
         load_index),
        ("j", jsvc_mod, JVariantEngine, JBeaconConfig, JEngineConfig,
         JIngestConfig, JStorageConfig, JIngestService, JPayload,
         __import__("sbeacon_tpu.index.columnar",
                    fromlist=["load_index"]).load_index),
    ):
        cfg = Cfg(storage=SCfg(root=tmp_path / tag),
                  engine=ECfg(use_mesh=False),
                  ingest=ICfg(compact_interval_s=0.0, workers=1,
                              delta_max_shards=1000, **SLICED))
        cfg.storage.ensure()
        eng = Eng(cfg, device="cpu") if tag == "t" else Eng(cfg)
        svc = Svc(cfg, engine=eng)
        published = threading.Event()
        real_merge = mod.merge_shards

        def slow_merge(shards, _real=real_merge, _ev=published,
                       _wait=2.0 if tag == "t" else 120.0):
            # the JAX fold merges until the summarisation has published;
            # the port's cannot (the final save waits on its lock), so
            # it merges after 2 s
            _ev.wait(timeout=_wait)
            return _real(shards)

        monkeypatch.setattr(mod, "merge_shards", slow_merge)
        folds = []
        real_add = eng.add_delta

        def add_delta(shard, _real=real_add, _eng=eng, _svc=svc):
            epoch = _real(shard)
            if epoch == 2:
                (key, base, tail), = _eng.delta_snapshot()
                th = threading.Thread(target=_svc.compactor._fold_base,
                                      args=(key, base, tail))
                th.start()
                folds.append(th)
            return epoch

        eng.add_delta = add_delta
        try:
            svc.pipeline.summarise_dataset("ds", [str(path)])
            want = _rows(eng, P)
            published.set()
            folds[0].join(60)
            assert not folds[0].is_alive()
            final = load(svc.pipeline.shard_path("ds", str(path)))
            out[tag] = (want, _rows(eng, P), final.n_rows)
        finally:
            published.set()
            for th in folds:
                th.join(60)
            monkeypatch.setattr(mod, "merge_shards", real_merge)
            close_service(svc)
            eng.close()
    (want, got, n_final), (jwant, jgot, jn_final) = out["t"], out["j"]
    assert want == jwant and got == want
    assert jgot[0] < jwant[0] and jgot[1] < jwant[1]
    assert n_final > jn_final


def test_background_folds_while_a_vcf_streams_keep_every_row(tmp_path):
    """The compactor thread sweeping every 10 ms while a VCF streams in
    many slices: after the submit every row is served exactly once."""
    path, recs = _streaming_vcf(tmp_path, n=300)
    want = build_index(
        [VcfRecord(**dataclasses.asdict(r)) for r in recs],
        dataset_id="ds", vcf_location=str(path),
        sample_names=[f"S{i:04d}" for i in range(3)])
    cfg = BeaconConfig(storage=StorageConfig(root=tmp_path / "t"),
                       engine=EngineConfig(use_mesh=False),
                       ingest=IngestConfig(compact_interval_s=0.01,
                                           delta_max_shards=2, workers=2,
                                           **SLICED))
    cfg.storage.ensure()
    eng = VariantEngine(cfg, device="cpu")
    svc = IngestService(cfg, engine=eng)
    try:
        assert svc.compactor._thread.is_alive()
        stats = svc.pipeline.summarise_dataset("ds", [str(path)])
        deadline = time.monotonic() + 10
        while eng.delta_stats() and time.monotonic() < deadline:
            time.sleep(0.02)
        mono = VariantEngine(BeaconConfig(engine=EngineConfig(
            use_mesh=False)), device="cpu")
        try:
            mono.add_index(want)
            for c, gran in [(c, g) for c in CHROMS
                            for g in ("count", "record")]:
                got = eng.search(VariantQueryPayload(**_q(c, gran)))
                ref = mono.search(VariantQueryPayload(**_q(c, gran)))
                assert sorted(v for r in got for v in r.variants) == sorted(
                    v for r in ref for v in r.variants)
                for field in ("call_count", "all_alleles_count"):
                    assert sum(getattr(r, field) for r in got) == sum(
                        getattr(r, field) for r in ref)
        finally:
            mono.close()
        final = load_index(svc.pipeline.shard_path("ds", str(path)))
        assert final.n_rows == want.n_rows
        assert stats["variantCount"] == distinct_variant_count([want])
    finally:
        close_service(svc)
        eng.close()
    assert not svc.compactor._thread.is_alive()


@pytest.mark.parametrize("ratio", [0.0, 0.35])
def test_deferred_base_publish_folds_equal(tmp_path, ratio):
    """``defer_base_publish``: the summarisation streams every slice as
    a delta and leaves the base publish to the compactor, whose
    ``run_once`` then adopts the persisted artifact. Both packages agree
    on the deferral, the stats, the rows served before and after the
    fold, the fold records, the compactor's counters and the base."""
    import sbeacon_tpu.index.columnar as jcol

    path, _recs = _streaming_vcf(tmp_path)
    svcs = {}
    for tag, Eng, Cfg, ECfg, ICfg, SCfg, Svc in (
        ("t", VariantEngine, BeaconConfig, EngineConfig, IngestConfig,
         StorageConfig, IngestService),
        ("j", JVariantEngine, JBeaconConfig, JEngineConfig, JIngestConfig,
         JStorageConfig, JIngestService),
    ):
        cfg = Cfg(storage=SCfg(root=tmp_path / tag),
                  engine=ECfg(use_mesh=False),
                  ingest=ICfg(compact_interval_s=0.0, workers=1,
                              delta_max_shards=1000,
                              defer_base_publish=True,
                              compact_base_ratio=ratio, **SLICED))
        cfg.storage.ensure()
        eng = Eng(cfg, device="cpu") if tag == "t" else Eng(cfg)
        svcs[tag] = Svc(cfg, engine=eng)
    t, j = svcs["t"], svcs["j"]
    vcf = str(path)
    try:
        stats = [s.pipeline.summarise_dataset("ds", [vcf]) for s in (t, j)]
        assert stats[0] == stats[1]
        for s in (t, j):
            assert s.pipeline.base_deferred("ds", vcf)
            assert not s.engine.has_index("ds", vcf)
        assert t.engine.delta_stats() == j.engine.delta_stats()
        assert len(t.engine.delta_tail("ds", vcf)) >= 2
        streamed = _rows(t.engine, VariantQueryPayload)
        assert streamed == _rows(j.engine, JPayload)
        assert t.compactor.run_once() == j.compactor.run_once()
        for s in (t, j):
            assert not s.pipeline.base_deferred("ds", vcf)
            assert s.engine.has_index("ds", vcf)
        assert t.engine.delta_stats() == j.engine.delta_stats() == {}
        assert _metrics(t.compactor) == _metrics(j.compactor)
        assert _log(t.compactor) == _log(j.compactor)
        assert t.ledger.delta_summary() == j.ledger.delta_summary()
        assert _rows(t.engine, VariantQueryPayload) == streamed
        assert _rows(j.engine, JPayload) == streamed
        assert_shards_equal(
            load_index(t.pipeline.shard_path("ds", vcf)),
            jcol.load_index(j.pipeline.shard_path("ds", vcf)))
    finally:
        for s in (t, j):
            close_service(s)
            s.engine.close()
