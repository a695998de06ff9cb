"""The port's simulation and benchmark harness against the JAX
package's, at tolerance 0.

Twins of the cases of ``tests/test_harness.py`` and
``tests/test_genome1k.py`` that have no wall-clock bound: ``populate``
through each package's ``/submit`` (the same records, entities and
ledger stats), the latency suite over live HTTP (the same checks, every
one answered), the metadata scale harness at toy size (the same counts
and query surface), the 1000-Genomes generator (the same VCF text and,
through each package's pipeline, the same merged shard) and its
resumable corpus build. Plus a round trip of ``cached_synthetic_shard``: a
miss builds ``testing.synthetic_shard`` (equal to JAX's cached shard),
a hit maps the same arrays back without a build, and a schema change
prunes the stale corpus. ``harness`` exposes the tooling lazily.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest

from sbeacon_tpu.api import BeaconApp as JBeaconApp
from sbeacon_tpu.config import BeaconConfig as JBeaconConfig
from sbeacon_tpu.config import StorageConfig as JStorageConfig
from sbeacon_tpu.harness import bench_cache as jbc
from sbeacon_tpu.harness import genome1k as jg
from sbeacon_tpu.harness import scale as jscale
from sbeacon_tpu.harness import simulate as jsim
from sbeacon_tpu_torch.api import BeaconApp
from sbeacon_tpu_torch.api.server import start_background
from sbeacon_tpu_torch.config import (
    BeaconConfig,
    IngestConfig,
    ObservabilityConfig,
    ShapingConfig,
    StorageConfig,
)
from sbeacon_tpu_torch.genomics.bgzf import BgzfReader
from sbeacon_tpu_torch.harness import bench_cache, genome1k, simulate
from sbeacon_tpu_torch.harness.latency import run_latency_suite
from sbeacon_tpu_torch.harness.scale import run_metadata_scale
from sbeacon_tpu_torch.testing import synthetic_shard
from torch_ingest_corpus import assert_shards_equal, no_thread_leak  # noqa: F401

POPULATE = dict(n_datasets=2, n_individuals=5, records_per_chrom=150)


def _close_app(app):
    app.close()
    app.engine.close()
    app.store.close()
    app.ontology.close()


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    """A port app populated through its own ``/submit`` and served over
    HTTP, with the records ``populate`` generated."""
    root = tmp_path_factory.mktemp("sim")
    # the brownout ladder off: on a loaded CPU a variant answer can take
    # longer than the default latency SLO, and the ladder would then
    # pause the bulk lane under the suites' record requests (429)
    config = BeaconConfig(
        storage=StorageConfig(root=root / "data"),
        ingest=IngestConfig(compact_interval_s=0),
        observability=ObservabilityConfig(canary_enabled=False),
        shaping=ShapingConfig(brownout=False))
    config.storage.ensure()
    app = BeaconApp(config, device="cpu")
    recs = simulate.populate(app, root / "vcfs", **POPULATE)
    server, thread = start_background(app)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        yield app, url, recs
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
        _close_app(app)


def test_populate_created_everything(live, tmp_path):
    """The same submissions as JAX's ``populate``: the same records,
    entity counts, served datasets and ledger stats."""
    app, _, recs = live
    jcfg = JBeaconConfig(storage=JStorageConfig(root=tmp_path / "j"))
    jcfg.storage.ensure()
    japp = JBeaconApp(jcfg)
    try:
        jrecs = jsim.populate(japp, tmp_path / "jvcfs", **POPULATE)
        assert set(recs) == set(jrecs) == {"sim0", "sim1"}
        for ds in recs:
            assert [dataclasses.asdict(r) for r in recs[ds]] == [
                dataclasses.asdict(r) for r in jrecs[ds]]
            job = app.ingest.ledger.dataset_job(ds)
            jjob = japp.ingest.ledger.dataset_job(ds)
            assert job["state"] == jjob["state"] == "complete"
            for k in ("variant_count", "call_count", "sample_count"):
                assert job[k] == jjob[k], (ds, k)
        for kind in ("datasets", "individuals", "biosamples", "runs",
                     "analyses"):
            assert app.store.count(kind) == japp.store.count(kind), kind
        assert app.store.count("individuals") == 10
        assert sorted(app.engine.datasets()) == sorted(
            japp.engine.datasets())
    finally:
        japp.close()
        japp.store.close()


def test_latency_suite_all_green(live):
    """Every check of the walk over the port's server answered (the
    suite raises on a bad answer), with no wall-clock bound."""
    _, url, _ = live
    results = run_latency_suite(url, reps=1)
    assert len(results) >= 18
    assert all(t >= 0 for t in results.values())


def test_latency_suite_checks_equal_jax(live):
    """The JAX suite's walk against the port's server: the same checks,
    every answer sane to the JAX harness too."""
    from sbeacon_tpu.harness.latency import run_latency_suite as j_suite

    _, url, _ = live
    assert sorted(j_suite(url, reps=1)) == sorted(run_latency_suite(
        url, reps=1))


def _jax_scale(root, **kw):
    """JAX's ``run_metadata_scale`` step by step, closing the app it
    builds (JAX's leaves its canary and compactor threads running)."""
    from sbeacon_tpu.metadata import MetadataStore, OntologyStore

    config = JBeaconConfig(storage=JStorageConfig(root=root))
    config.storage.ensure()
    ontology = OntologyStore(config.storage.ontology_db)
    store = MetadataStore(config.storage.metadata_db, ontology=ontology)
    jscale.seed_phenotype_closure(ontology)
    rep = {"populate": jscale.populate_metadata_bulk(store, **kw)}
    store.rebuild_indexes()
    for k, table in (("terms_rows", "terms"),
                     ("terms_index_rows", "terms_index"),
                     ("relations_rows", "relations")):
        rep[k] = int(store.query(f"SELECT COUNT(*) FROM {table}")[0][0])
    app = JBeaconApp(config, store=store, ontology=ontology)
    try:
        rep["queries"] = jscale.measure_metadata_plane(app)
    finally:
        app.close()
        store.close()
        ontology.close()
    return rep


def test_metadata_scale_harness_small(tmp_path):
    """The scale harness at toy size: the same bulk-seeded counts and
    query surface as JAX's, ontology-expanded counts that match."""
    rep = run_metadata_scale(tmp_path / "t", n_datasets=5,
                             individuals_per=30, device="cpu")
    jrep = _jax_scale(tmp_path / "j", n_datasets=5, individuals_per=30)
    assert rep["populate"]["individuals"] == 150
    assert rep["relations_rows"] >= 150
    for k in ("terms_rows", "terms_index_rows", "relations_rows"):
        assert rep[k] == jrep[k], k
    assert {k: v for k, v in rep["populate"].items()
            if not k.endswith(("seconds", "_per_s"))} == {
        k: v for k, v in jrep["populate"].items()
        if not k.endswith(("seconds", "_per_s"))}
    assert rep["queries"]["ontology_count_result"] == jrep["queries"][
        "ontology_count_result"] > 0
    assert set(rep["queries"]) == set(jrep["queries"])
    for key in ("individuals_sex_boolean", "individuals_sex_count",
                "individuals_sex_record", "individuals_ontology_count",
                "dataset_individuals_record"):
        assert rep["queries"][key]["p50_ms"] > 0


def test_generated_cohort_through_real_pipeline(tmp_path):
    """The generator's VCFs through the port's pipeline: the manifest's
    counts and the merged shard equal JAX's, and INFO AC equals the
    painted carriers."""
    kw = dict(total_records=2500, n_samples=37, chroms=["21", "22"],
              seed=5)
    m = genome1k.build_corpus(tmp_path / "t", **kw)
    jm = jg.build_corpus(tmp_path / "j", **kw)
    assert m["totals"]["records"] == jm["totals"]["records"] == 2500
    shard = genome1k.load_merged(tmp_path / "t", ["21", "22"])
    jshard = jg.load_merged(tmp_path / "j", ["21", "22"])
    assert_shards_equal(shard, jshard, meta=False)
    assert shard.meta["sample_count"] == 37
    c = shard.cols
    g1 = np.bitwise_count(shard.gt_bits).sum(axis=1)
    g2 = np.bitwise_count(shard.gt_bits2).sum(axis=1)
    np.testing.assert_array_equal(c["ac"], g1 + g2)
    assert (c["an"] == 74).all()
    assert (np.bitwise_count(shard.tok_bits1).sum(axis=1) == 37).all()


def test_build_corpus_resumes(tmp_path):
    genome1k.build_corpus(tmp_path, total_records=600, n_samples=5,
                          chroms=["22"], seed=2)
    first = json.loads((tmp_path / "manifest.json").read_text())
    genome1k.build_corpus(tmp_path, total_records=600, n_samples=5,
                          chroms=["22"], seed=2)
    again = json.loads((tmp_path / "manifest.json").read_text())
    assert again["chroms"]["22"] == first["chroms"]["22"]


def test_chrom_record_counts_proportional():
    chroms = [str(i) for i in range(1, 23)]
    counts = genome1k.chrom_record_counts(1_000_000, chroms)
    assert counts == jg.chrom_record_counts(1_000_000, chroms)
    assert sum(counts.values()) == 1_000_000
    assert counts["1"] > counts["22"] * 3


@pytest.mark.parametrize("kw", [
    dict(chrom="20", n_records=4000, n_samples=4, seed=8,
         position_model="clustered"),
    dict(chrom="22", n_records=3000, n_samples=2, seed=1,
         p_multiallelic=1.0, p_indel=0.0),
])
def test_cohort_vcf_text_equal(tmp_path, kw):
    """The generator writes JAX's VCF text (clustered positions; all
    multi-allelic lines with both ALTs distinct from REF)."""
    out = genome1k.write_cohort_vcf(tmp_path / "t.vcf.gz", **kw)
    jout = jg.write_cohort_vcf(tmp_path / "j.vcf.gz", **kw)
    assert out["records"] == jout["records"] == kw["n_records"]
    text = BgzfReader(tmp_path / "t.vcf.gz").read_all()
    assert text == BgzfReader(tmp_path / "j.vcf.gz").read_all()
    if kw.get("p_multiallelic") == 1.0:
        checked = 0
        for line in text.decode().splitlines():
            if line.startswith("#"):
                continue
            f = line.split("\t")
            ref, alts = f[3], f[4].split(",")
            assert len(alts) == 2
            assert ref not in alts and alts[0] != alts[1], line
            checked += 1
        assert checked == kw["n_records"]


def test_cached_synthetic_shard_round_trip(tmp_path):
    """A miss builds and persists ``testing.synthetic_shard``; a hit maps
    the same arrays back with no build; the cached shard equals JAX's
    cached shard of the same request; a schema change prunes it."""
    kw = dict(n_samples=40, seed=3, dataset_id="bc", with_gt_planes=True)
    shard, build_s = bench_cache.cached_synthetic_shard(
        5000, cache_root=tmp_path / "t", **kw)
    assert build_s > 0.0
    assert_shards_equal(shard, synthetic_shard(5000, **kw))
    again, hit_s = bench_cache.cached_synthetic_shard(
        5000, cache_root=tmp_path / "t", **kw)
    assert hit_s == 0.0
    assert isinstance(again.cols["pos"], np.memmap)
    assert_shards_equal(again, shard)
    jshard, _ = jbc.cached_synthetic_shard(5000, cache_root=tmp_path / "j",
                                           **kw)
    assert_shards_equal(again, jshard)
    (entry,) = (tmp_path / "t").iterdir()
    assert entry.name.startswith(f"shard-{bench_cache._schema_hash()}-")
    stale = tmp_path / "t" / "shard-000000000000-x"
    stale.mkdir()
    bench_cache.cached_synthetic_shard(4000, cache_root=tmp_path / "t",
                                       **kw)
    assert not stale.exists() and len(list((tmp_path / "t").iterdir())) == 2
    assert bench_cache.default_cache_root().parts[-2:] == ("build",
                                                          "bench_cache")


def test_harness_tooling_is_lazy():
    """Importing the harness (as every server process does, for its
    fault points) loads ``faults`` alone; the tooling resolves on use."""
    code = ("import sys, sbeacon_tpu_torch.harness as h; "
            "assert not [m for m in sys.modules if m.startswith("
            "'sbeacon_tpu_torch.harness.') and m != "
            "'sbeacon_tpu_torch.harness.faults'], sorted(sys.modules); "
            "assert h.cached_synthetic_shard.__module__.endswith("
            "'bench_cache'); assert h.run_concurrent_soak and h.populate "
            "and h.run_metadata_scale and h.random_submission")
    subprocess.run([sys.executable, "-c", code], check=True)
