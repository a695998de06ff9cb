"""The port's summarisation pipeline against the JAX package's, at
tolerance 0: the slice planner, the job ledger (claims, pending slices,
delta publishes, compactions, crash resume from claimed slices), the
shards, stats, ledger rows, portable region files and distinct count of
one VCF through both pipelines (local and ``http://``), the epochs a
first-time summarisation streams into each package's engine and the
rows those engines then serve, the shard wire form, and the ingest
metrics.
"""

from __future__ import annotations

import dataclasses
import random
import sys
import threading

import numpy as np
import pytest
import torch

from sbeacon_tpu.config import BeaconConfig as JBeaconConfig
from sbeacon_tpu.config import EngineConfig as JEngineConfig
from sbeacon_tpu.config import IngestConfig as JIngestConfig
from sbeacon_tpu.config import StorageConfig as JStorageConfig
from sbeacon_tpu.engine import VariantEngine as JVariantEngine
from sbeacon_tpu.genomics.tabix import ensure_index as j_ensure_index
from sbeacon_tpu.index import columnar as jc
from sbeacon_tpu.index import portable as jp
from sbeacon_tpu.ingest import ledger as jl
from sbeacon_tpu.ingest import pipeline as jpl
from sbeacon_tpu.ingest import planner as jpn
from sbeacon_tpu.payloads import VariantQueryPayload as JPayload
from sbeacon_tpu.telemetry import MetricsRegistry as JRegistry
from sbeacon_tpu.testing import make_test_vcf as j_make_test_vcf
from sbeacon_tpu_torch.config import (
    BeaconConfig,
    EngineConfig,
    IngestConfig,
    StorageConfig,
)
from sbeacon_tpu_torch.engine import VariantEngine
from sbeacon_tpu_torch.genomics.tabix import ensure_index
from sbeacon_tpu_torch.index import columnar as tc
from sbeacon_tpu_torch.index import portable as tp
from sbeacon_tpu_torch.ingest import ledger as tl
from sbeacon_tpu_torch.ingest import pipeline as tpl
from sbeacon_tpu_torch.ingest import planner as tpn
from sbeacon_tpu_torch.payloads import VariantQueryPayload
from sbeacon_tpu_torch.telemetry import MetricsRegistry
from sbeacon_tpu_torch.testing import range_server
from torch_ingest_corpus import assert_shards_equal, no_thread_leak  # noqa: F401

#: a slice budget tiny enough to cut a small VCF into several slices
SMALL = dict(min_task_time=1e-6, scan_rate=1e6, dispatch_cost=1e-7,
             max_concurrency=1000, compact_interval_s=0.0)


def _vcf(tmp_path, name="c.vcf.gz", seed=13, chroms=("1", "2"), n=300,
         n_samples=3, **kw):
    path = tmp_path / "vcfs" / name
    path.parent.mkdir(exist_ok=True)
    recs = j_make_test_vcf(path, seed=seed, chroms=chroms, n_per_chrom=n,
                           n_samples=n_samples, **kw)
    j_ensure_index(path)
    return path, recs


def _configs(tmp_path, **ingest):
    kw = {**SMALL, **ingest}
    j = JBeaconConfig(storage=JStorageConfig(root=tmp_path / "j"),
                      engine=JEngineConfig(use_mesh=False),
                      ingest=JIngestConfig(**kw))
    t = BeaconConfig(storage=StorageConfig(root=tmp_path / "t"),
                     engine=EngineConfig(use_mesh=False),
                     ingest=IngestConfig(**kw))
    j.storage.ensure()
    t.storage.ensure()
    return j, t


def _pipelines(tmp_path, *, engines=False, **ingest):
    jcfg, tcfg = _configs(tmp_path, **ingest)
    jeng = teng = None
    if engines:
        jeng = JVariantEngine(jcfg)
        teng = VariantEngine(tcfg, device="cpu")
    jp_ = jpl.SummarisationPipeline(jcfg, ledger=jl.JobLedger(), engine=jeng)
    tp_ = tpl.SummarisationPipeline(tcfg, ledger=tl.JobLedger(), engine=teng)
    return jp_, tp_


def _close(*pipes):
    for p in pipes:
        if p.engine is not None:
            p.engine.close()
        p.ledger.close()


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


# -- the planner ----------------------------------------------------------


COSTS = [
    dict(min_task_time=0.1, scan_rate=75_000_000, dispatch_cost=0.02,
         max_concurrency=1000),
    dict(min_task_time=1e-6, scan_rate=1e6, dispatch_cost=1e-7,
         max_concurrency=1000),
    dict(min_task_time=1e-9, scan_rate=1e3, dispatch_cost=1e-10,
         max_concurrency=4),
    {},
]


@pytest.mark.parametrize("cost", COSTS)
def test_slice_plans_equal(tmp_path, cost):
    path, _ = _vcf(tmp_path, chroms=("1", "2", "X"), n=1500, spacing=400)
    it, ij = ensure_index(path), j_ensure_index(path)
    a = tpn.plan_slices(it, IngestConfig(**cost))
    b = jpn.plan_slices(ij, JIngestConfig(**cost))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert tpn.chunk_boundaries(it) == jpn.chunk_boundaries(ij)
    for total in (10_000_000, 5_000_000_000):
        assert tpn.find_best_split(total, total / 1e6, IngestConfig(**cost)) \
            == jpn.find_best_split(total, total / 1e6, JIngestConfig(**cost))


def test_partition_and_pack_ranges_equal():
    bounds = {"1": [(10 << 16), (50 << 16), (120 << 16), (300 << 16)],
              "2": [(400 << 16), (450 << 16) | 7, (900 << 16)]}
    for size in (1.0, 100.0, 1e9):
        assert tpn.partition_chunks(bounds, size) == jpn.partition_chunks(
            bounds, size)
    items = [(0, 10, 400), (10, 20, 400), (20, 30, 400), (30, 40, 100)]
    for cap in (1, 800, 10_000):
        assert tpn.pack_ranges(items, cap) == jpn.pack_ranges(items, cap)
    assert tpn.pack_ranges([], 5) == jpn.pack_ranges([], 5) == []


# -- the ledger -----------------------------------------------------------


def _ledger_ops(ledger):
    """One sequence of every ledger write; returns what each read says."""
    out = []
    slices = [(0, 100), (100, 250), (250, 900)]
    out.append(ledger.mark_updating("v.vcf.gz", slices))
    out.append(ledger.mark_updating("v.vcf.gz", slices))  # claimed
    out.append(ledger.claimed_slices("v.vcf.gz"))
    ledger.set_sample_count("v.vcf.gz", 7)
    out.append(ledger.complete_slice("v.vcf.gz", slices[1],
                                     variant_count=5, call_count=70))
    out.append(ledger.complete_slice("v.vcf.gz", slices[1],
                                     variant_count=5, call_count=70))
    out.append(ledger.pending_slices("v.vcf.gz"))
    out.append(ledger.vcf_summary("v.vcf.gz"))
    out.append(ledger.vcf_is_summarised("v.vcf.gz"))
    for s in (slices[0], slices[2]):
        out.append(ledger.complete_slice("v.vcf.gz", s, variant_count=2,
                                         call_count=9))
    out.append(ledger.vcf_is_summarised("v.vcf.gz"))
    out.append(ledger.vcf_summary("missing"))
    ledger.start_dataset("ds", ["v.vcf.gz", "w.vcf.gz"])
    out.append(ledger.dataset_job("ds"))
    ledger.finish_dataset("ds", variant_count=8, call_count=88,
                          sample_count=7)
    out.append(ledger.dataset_job("ds"))
    for e in (1, 2, 3):
        ledger.record_delta_publish("ds", "v.vcf.gz", e, 10 * e)
    ledger.record_compaction("ds", "v.vcf.gz", folded_through=2,
                             folded_shards=2, folded_rows=30, tier="l1",
                             in_bytes=100, out_bytes=90, write_amp=0.9)
    ledger.record_compaction("ds", "v.vcf.gz", folded_through=3,
                             folded_shards=1, folded_rows=30)
    out.append(ledger.delta_summary())
    out.append([{k: v for k, v in r.items() if k != "completedAt"}
                for r in ledger.compaction_log()])
    out.append(ledger.compaction_log("other"))
    return out


def test_ledger_rows_equal(tmp_path):
    got = _ledger_ops(tl.JobLedger(tmp_path / "t.sqlite"))
    want = _ledger_ops(jl.JobLedger(tmp_path / "j.sqlite"))
    assert got == want
    # the same file read by the other package (one sqlite schema)
    a = tl.JobLedger(tmp_path / "j.sqlite")
    b = jl.JobLedger(tmp_path / "t.sqlite")
    assert a.dataset_job("ds") == b.dataset_job("ds")
    assert a.claimed_slices("v.vcf.gz") == b.claimed_slices("v.vcf.gz")
    assert a.delta_summary() == b.delta_summary()
    a.close()
    b.close()


def test_ledger_reads_under_concurrent_writes(tmp_path):
    """Reads interleave with other threads' transactions on the one
    shared connection without error and never see a half-written
    claim."""
    ledger = tl.JobLedger(tmp_path / "l.sqlite")
    errors = []

    def writer(k):
        try:
            for i in range(60):
                v = f"v{k}-{i}"
                ledger.mark_updating(v, [(0, 1), (1, 2)])
                ledger.complete_slice(v, (0, 1), variant_count=1,
                                      call_count=2)
                ledger.record_delta_publish("ds", v, 1, 3)
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    def reader():
        try:
            for i in range(300):
                s = ledger.vcf_summary(f"v0-{i % 60}")
                assert s is None or s["pending"] in (["0-1", "1-2"],
                                                     ["1-2"])
                ledger.delta_summary()
                ledger.compaction_log()
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(k,)) for k in range(3)]
    threads += [threading.Thread(target=reader) for _ in range(9)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert ledger.delta_summary()["delta_publishes"] == 180
    ledger.close()


# -- the pipeline ---------------------------------------------------------


@pytest.mark.parametrize("n_samples,workers,portable", [
    (3, 1, True), (0, 1, True), (70, 4, False), (2, 8, True),
])
def test_summarise_dataset_parity(tmp_path, n_samples, workers, portable):
    v1, recs = _vcf(tmp_path, n_samples=n_samples)
    v2, _ = _vcf(tmp_path, name="d.vcf.gz", seed=14, chroms=("2", "3"),
                 n=150, n_samples=n_samples)
    jpipe, tpipe = _pipelines(tmp_path, workers=workers,
                              export_portable=portable)
    try:
        plan = tpn.plan_slices(ensure_index(v1), tpipe.config.ingest)
        assert len(plan.slices) >= 2
        vcfs = [str(v1), str(v2)]
        a = tpipe.summarise_dataset("ds", vcfs)
        b = jpipe.summarise_dataset("ds", vcfs)
        assert a == b
        assert a["sampleCount"] == n_samples
        for v in vcfs:
            assert_shards_equal(tc.load_index(tpipe.shard_path("ds", v)),
                                jc.load_index(jpipe.shard_path("ds", v)))
            assert tpipe.ledger.vcf_summary(v) == jpipe.ledger.vcf_summary(v)
        assert tpipe.ledger.dataset_job("ds") == jpipe.ledger.dataset_job(
            "ds")
        troot = tpipe.config.storage.index_dir / "portable"
        jroot = jpipe.config.storage.index_dir / "portable"
        assert troot.exists() == jroot.exists() == portable
        if portable:
            assert _tree(troot) == _tree(jroot)
            assert tp.distinct_variant_count_files([troot / "ds"]) == \
                jp.distinct_variant_count_files([jroot / "ds"]) == \
                a["variantCount"]
        # no slice file is left behind, and the disk gauge is back at 0
        assert not list(tpipe.config.storage.index_dir.rglob("*.slices"))
        assert tpl.SLICE_DISK.stats()["current"] == 0
        # explicit groups count each group's samples once
        g = tpipe.summarise_dataset("ds", vcfs, vcf_groups=[[vcfs[0]],
                                                            [vcfs[1]]])
        assert g == jpipe.summarise_dataset("ds", vcfs, vcf_groups=[
            [vcfs[0]], [vcfs[1]]])
        assert g["sampleCount"] == 2 * n_samples
    finally:
        _close(jpipe, tpipe)


def test_resume_after_crash_parity(tmp_path, monkeypatch):
    v, _ = _vcf(tmp_path)
    jpipe, tpipe = _pipelines(tmp_path, workers=1)
    try:
        plan = tpn.plan_slices(ensure_index(v), tpipe.config.ingest)
        poison = plan.slices[len(plan.slices) // 2]
        for mod in (tpl, jpl):
            real = mod.scan_slice_to_shard
            state = {"n": 0}

            def flaky(path, a, b, _real=real, _state=state, **kw):
                if (a, b) == poison and _state["n"] == 0:
                    _state["n"] += 1
                    raise RuntimeError("simulated crash")
                return _real(path, a, b, **kw)

            monkeypatch.setattr(mod, "scan_slice_to_shard", flaky)
        for pipe in (tpipe, jpipe):
            with pytest.raises(RuntimeError):
                pipe.summarise_vcf("ds", str(v))
        assert tpipe.ledger.pending_slices(str(v)) == \
            jpipe.ledger.pending_slices(str(v))
        assert poison in tpipe.ledger.pending_slices(str(v))
        assert tpipe.ledger.claimed_slices(str(v)) == plan.slices
        a = tpipe.summarise_vcf("ds", str(v))
        b = jpipe.summarise_vcf("ds", str(v))
        assert_shards_equal(a, b)
        assert tpipe.ledger.vcf_summary(str(v)) == jpipe.ledger.vcf_summary(
            str(v))
        # the third run short-circuits on the persisted shard
        assert_shards_equal(tpipe.summarise_vcf("ds", str(v)), a)
    finally:
        _close(jpipe, tpipe)


def test_resume_uses_claimed_plan(tmp_path):
    v, recs = _vcf(tmp_path, chroms=("4",), n=2000, spacing=400)
    jpipe, tpipe = _pipelines(tmp_path)
    try:
        plan = tpn.plan_slices(ensure_index(v), tpipe.config.ingest)
        for pipe in (tpipe, jpipe):
            assert pipe.ledger.mark_updating(str(v), plan.slices)
        drift = dict(min_task_time=100.0, scan_rate=1e9, dispatch_cost=10.0)
        t2 = tpl.SummarisationPipeline(
            dataclasses.replace(tpipe.config, ingest=dataclasses.replace(
                tpipe.config.ingest, **drift)), ledger=tpipe.ledger)
        j2 = jpl.SummarisationPipeline(
            dataclasses.replace(jpipe.config, ingest=dataclasses.replace(
                jpipe.config.ingest, **drift)), ledger=jpipe.ledger)
        assert tpn.plan_slices(ensure_index(v), t2.config.ingest).slices \
            != plan.slices
        assert_shards_equal(t2.summarise_vcf("ds", str(v)),
                            j2.summarise_vcf("ds", str(v)))
        assert t2.ledger.vcf_summary(str(v))["pending"] == []
    finally:
        _close(jpipe, tpipe)


def test_concurrent_summarisation_serialises(tmp_path):
    v, _ = _vcf(tmp_path)
    _jpipe, tpipe = _pipelines(tmp_path)
    results, errors = [], []

    def run():
        try:
            results.append(tpipe.summarise_vcf("ds", str(v)))
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    try:
        assert not any(t.is_alive() for t in threads)
        assert not errors and len({s.n_rows for s in results}) == 1
        want = jc.load_index(tpipe.shard_path("ds", str(v)))
        assert tpipe.ledger.vcf_summary(str(v))["variant_count"] == \
            want.n_rows
    finally:
        _close(_jpipe, tpipe)


def _payloads(shard, n, seed):
    rng = random.Random(seed)
    out = []
    for k in range(n):
        i = rng.randrange(shard.n_rows)
        p = int(shard.cols["pos"][i])
        w = rng.choice([0, 50, 4000])
        out.append(dict(
            dataset_ids=[], reference_name=shard.row_chrom(i),
            start_min=p - w, start_max=p + w, end_min=p - w,
            end_max=p + w + 64, alternate_bases="N",
            requested_granularity=("boolean", "count", "record")[k % 3],
            include_datasets="HIT"))
    return out


def _search_equal(jeng, teng, docs):
    for d in docs:
        a = teng.search(VariantQueryPayload(**d))
        b = jeng.search(JPayload(**d))
        assert [dataclasses.asdict(r) for r in a] == [
            dataclasses.asdict(r) for r in b]


def test_streamed_epochs_and_served_rows_parity(tmp_path):
    v, _ = _vcf(tmp_path, n_samples=5, n=400)
    jpipe, tpipe = _pipelines(tmp_path, engines=True, workers=1)
    seen = {"t": [], "j": []}
    for tag, pipe in (("t", tpipe), ("j", jpipe)):
        eng = pipe.engine
        real = eng.add_delta

        def add_delta(shard, _real=real, _tag=tag, _eng=eng):
            epoch = _real(shard)
            # the rows of every epoch so far serve at once
            seen[_tag].append((epoch, shard, _eng.delta_tail(
                shard.meta["dataset_id"], shard.meta["vcf_location"])))
            return epoch

        eng.add_delta = add_delta
    try:
        assert tpipe._streaming("ds", str(v)) and jpipe._streaming(
            "ds", str(v))
        a = tpipe.summarise_dataset("ds", [str(v)])
        b = jpipe.summarise_dataset("ds", [str(v)])
        assert a == b
        assert len(seen["t"]) == len(seen["j"]) >= 2
        for (et, st, tt), (ej, sj, tj) in zip(seen["t"], seen["j"]):
            assert et == ej and tt == tj
            assert_shards_equal(st, sj)
        # the inline fold retired every streamed epoch in both engines
        for pipe in (tpipe, jpipe):
            assert pipe.engine.delta_stats() == {} or not any(
                pipe.engine.delta_stats().values())
        assert tpipe.ledger.delta_summary() == jpipe.ledger.delta_summary()
        assert [{k: x for k, x in r.items() if k != "completedAt"}
                for r in tpipe.ledger.compaction_log()] == [
            {k: x for k, x in r.items() if k != "completedAt"}
            for r in jpipe.ledger.compaction_log()]
        base = tc.load_index(tpipe.shard_path("ds", str(v)))
        assert base.meta["delta_epoch"] == len(seen["t"])
        _search_equal(jpipe.engine, tpipe.engine, _payloads(base, 30, 1))
        # a served VCF is not streamed again
        assert not tpipe._streaming("ds", str(v))
        assert not jpipe._streaming("ds", str(v))
    finally:
        _close(jpipe, tpipe)


def test_mid_stream_rows_parity(tmp_path):
    """After each streamed slice, both engines answer the same rows."""
    v, recs = _vcf(tmp_path, n_samples=3, n=300)
    jpipe, tpipe = _pipelines(tmp_path, engines=True, workers=1)
    probe = jc.build_index(recs, dataset_id="ds", vcf_location=str(v))
    docs = _payloads(probe, 12, 2)
    answers = {"t": [], "j": []}
    try:
        for tag, pipe, cls in (("t", tpipe, VariantQueryPayload),
                               ("j", jpipe, JPayload)):
            eng = pipe.engine
            real = eng.add_delta

            def add_delta(shard, _real=real, _tag=tag, _eng=eng, _cls=cls):
                epoch = _real(shard)
                answers[_tag].append(
                    [[dataclasses.asdict(r) for r in _eng.search(_cls(**d))]
                     for d in docs])
                return epoch

            eng.add_delta = add_delta
        tpipe.summarise_dataset("ds", [str(v)])
        jpipe.summarise_dataset("ds", [str(v)])
        assert answers["t"] == answers["j"] and len(answers["t"]) >= 2
    finally:
        _close(jpipe, tpipe)


def test_remote_summarisation_parity(tmp_path):
    v, _ = _vcf(tmp_path, n_samples=4)
    jpipe, tpipe = _pipelines(tmp_path, workers=2)
    try:
        with range_server(v.parent) as base:
            url = f"{base}/{v.name}"
            a = tpipe.summarise_vcf("ds", url)
            b = jpipe.summarise_vcf("ds", url)
        assert_shards_equal(a, b)
        local = tpipe.summarise_vcf("local", str(v))
        assert_shards_equal(a, local, meta=False)
        assert a.meta["vcf_location"] == url
    finally:
        _close(jpipe, tpipe)


def test_malformed_blob_falls_back_per_blob(tmp_path, monkeypatch):
    from sbeacon_tpu_torch import native

    v, _ = _vcf(tmp_path, n=2000, n_samples=2)
    slices = tpn.plan_slices(ensure_index(v), IngestConfig(
        min_task_time=1e-9, scan_rate=1e3, dispatch_cost=1e-10,
        max_concurrency=1000)).slices
    assert len(slices) >= 2
    monkeypatch.setattr(native, "prefer_native_io", lambda: True)
    real = native.inflate_buffer
    state = {"fail": False}

    def flaky(data, vstart=0, vend=None, **kw):
        if state["fail"]:
            raise ValueError("synthetic native refusal")
        return real(data, vstart, vend, **kw)

    monkeypatch.setattr(native, "inflate_buffer", flaky)
    reg = MetricsRegistry()
    tpl.register_ingest_metrics(reg)
    jreg = JRegistry()
    jpl.register_ingest_metrics(jreg)
    assert reg.names() == jreg.names()
    fb0 = tpl.NATIVE_FALLBACKS.count()

    def scan(url, sl):
        return tpl.scan_slice_to_shard(url, sl[0], sl[1], dataset_id="d",
                                       sample_names=["S0000", "S0001"])

    with range_server(v.parent) as base:
        url = f"{base}/{v.name}"
        good = scan(url, slices[1])
        assert tpl.NATIVE_FALLBACKS.count() == fb0
        state["fail"] = True
        broken = scan(url, slices[1])
        assert tpl.NATIVE_FALLBACKS.count() == fb0 + 1
        state["fail"] = False
        scan(url, slices[0])
        assert tpl.NATIVE_FALLBACKS.count() == fb0 + 1
    assert_shards_equal(good, broken)
    assert reg.render_json()["ingest"]["native_fallbacks"] == \
        tpl.NATIVE_FALLBACKS.count()


@pytest.mark.parametrize("max_range_bytes", [None, 256, 10_000])
def test_distinct_variant_count_equal(tmp_path, max_range_bytes):
    v1, recs = _vcf(tmp_path, n_samples=0)
    v2, recs2 = _vcf(tmp_path, name="e.vcf.gz", seed=13, chroms=("2",),
                     n=300, n_samples=0)
    shards = [jc.build_index(recs, dataset_id="a"),
              jc.build_index(recs2, dataset_id="b")]
    want = jpl.distinct_variant_count(shards,
                                      max_range_bytes=max_range_bytes)
    got = tpl.distinct_variant_count(
        [tc.shard_from_reference(s) for s in shards],
        max_range_bytes=max_range_bytes)
    assert got == want == len({(r.chrom, r.pos, r.ref, a)
                               for r in recs + recs2 for a in r.alts})


# -- portable region files and the shard wire form ---------------------------


@pytest.mark.parametrize("n_samples", [0, 5])
def test_portable_export_and_codec_equal(tmp_path, n_samples):
    _v, recs = _vcf(tmp_path, chroms=("1", "X", "MT"), n=400, spacing=5000,
                    n_samples=n_samples)
    shard = jc.build_index(recs, dataset_id="dP", vcf_location="p.vcf.gz")
    tshard = tc.shard_from_reference(shard)
    a = tp.export_region_files(tshard, tmp_path / "t", max_gap=20_000)
    b = jp.export_region_files(shard, tmp_path / "j", max_gap=20_000)
    assert [p.relative_to(tmp_path / "t") for p in a] == [
        p.relative_to(tmp_path / "j") for p in b]
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    assert [f[:2] + f[3:] for f in tp.iter_region_files(tmp_path / "t")] == [
        f[:2] + f[3:] for f in jp.iter_region_files(tmp_path / "j")]
    assert tp.distinct_variant_count_files([tmp_path / "t"]) == \
        jp.distinct_variant_count_files([tmp_path / "j"])
    for f in a:
        assert tp.parse_region_filename(f) == jp.parse_region_filename(f)
    for seq in (b"A", b"ACGTN", b"<DEL>", b"acgt", b"", b"GATTACA*"):
        assert tp.pack_seq(seq) == jp.pack_seq(seq)
        assert tp.packed_len(seq) == jp.packed_len(seq)
    np.testing.assert_array_equal(
        tp.packed_len_rows(tshard.ref_blob, tshard.ref_off),
        jp.packed_len_rows(shard.ref_blob, shard.ref_off))
    # re-export clears the stale files of the location
    tp.export_region_files(tshard, tmp_path / "t", max_gap=10**9)
    jp.export_region_files(shard, tmp_path / "j", max_gap=10**9)
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")


def test_remote_region_files_via_manifest(tmp_path):
    _v, recs = _vcf(tmp_path, chroms=("3",), n=250, n_samples=1)
    shard = tc.build_index([r for r in recs], dataset_id="dP",
                           vcf_location="p.vcf.gz")
    out = tmp_path / "portable" / "dP"
    tp.export_region_files(shard, out)
    with range_server(tmp_path) as base:
        remote = f"{base}/portable/dP"
        assert [f[:2] + f[3:] for f in tp.iter_region_files(remote)] == [
            f[:2] + f[3:] for f in tp.iter_region_files(out)]
        assert tp.distinct_variant_count_files([remote]) == \
            jp.distinct_variant_count_files([out])


def test_shard_wire_form_crosses_packages(tmp_path):
    _v, recs = _vcf(tmp_path, n_samples=6)
    j = jc.build_index(recs, dataset_id="w", vcf_location="w.vcf")
    t = tc.shard_from_reference(j)
    assert_shards_equal(tc.loads_index(jc.dumps_index(j)), j)
    assert_shards_equal(jc.loads_index(tc.dumps_index(t)), j)
    meta = tc.save_index_blob(jc.dumps_index(j), tmp_path / "s" / "x.npz")
    assert meta == j.meta
    assert_shards_equal(jc.load_index(tmp_path / "s" / "x.npz"), j)
    assert_shards_equal(tc.load_index(tmp_path / "s" / "x.npz"), j)


def test_ingest_config_and_refusal():
    """The whole ``IngestConfig`` equals JAX's, the remote scan pool's
    knobs included, and ``scan_worker_urls`` is accepted (it was
    refused before the fleet's ingest plane was ported)."""
    from sbeacon_tpu.config import BeaconConfig as JB
    from sbeacon_tpu.config import IngestConfig as JI

    assert dataclasses.asdict(BeaconConfig().ingest) == \
        dataclasses.asdict(JB().ingest)
    assert dataclasses.asdict(BeaconConfig().resolvers) == \
        dataclasses.asdict(JB().resolvers)
    kw = dict(scan_worker_urls=("http://w:1",), scan_timeout_s=7.0,
              scan_retries=3)
    assert dataclasses.asdict(IngestConfig(**kw)) == \
        dataclasses.asdict(JI(**kw))


@pytest.mark.parametrize("env", [
    {"BEACON_COMPACT_BASE_RATIO": "0", "BEACON_STREAM_DELTAS": "off",
     "BEACON_DELTA_MAX_SHARDS": "3", "BEACON_COMPACT_INTERVAL_S": "0.5"},
    {"BEACON_INGEST_WORKERS": "2", "BEACON_ARTIFACT_RETAIN": "5",
     "BEACON_DEFER_BASE_PUBLISH": "1", "BEACON_RESOLVE_ONTOLOGIES": "yes",
     "BEACON_OLS_URL": "http://o", "BEACON_RESOLVER_WORKERS": "3"},
])
def test_ingest_env_overrides_equal(monkeypatch, env):
    from sbeacon_tpu.config import BeaconConfig as JB

    for k, val in env.items():
        monkeypatch.setenv(k, val)
    a, b = BeaconConfig.from_env(), JB.from_env()
    assert dataclasses.asdict(a.ingest) == dataclasses.asdict(b.ingest)
    assert dataclasses.asdict(a.resolvers) == dataclasses.asdict(b.resolvers)


def test_scan_workers_env_refused(monkeypatch):
    """``BEACON_SCAN_WORKERS`` now names the scan workers, as in JAX."""
    from sbeacon_tpu.config import BeaconConfig as JB

    monkeypatch.setenv("BEACON_SCAN_WORKERS", "http://a:1, http://b:2")
    a, b = BeaconConfig.from_env(), JB.from_env()
    assert a.ingest.scan_worker_urls == ("http://a:1", "http://b:2")
    assert dataclasses.asdict(a.ingest) == dataclasses.asdict(b.ingest)


def test_cpu_engine_tensors_stay_on_the_cpu(tmp_path):
    """The pipeline's engine publishes land on the engine's device."""
    v, _ = _vcf(tmp_path, n_samples=2, n=100)
    _j, tpipe = _pipelines(tmp_path, engines=True)
    try:
        tpipe.summarise_dataset("ds", [str(v)])
        (_k, (_s, dindex, _p)), = list(tpipe.engine._indexes.items())
        tensors = [x for x in vars(dindex).values()
                   if isinstance(x, torch.Tensor)]
        assert tensors and all(x.device.type == "cpu" for x in tensors)
    finally:
        _close(_j, tpipe)
