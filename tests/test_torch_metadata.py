"""The port's metadata store held against the JAX package's.

The cases of tests/test_metadata.py run on both packages: the same
ontology edges and entity documents go into a JAX ``MetadataStore`` and
the port's, and every read (rows, counts, existence, filtering terms,
sample names, relations) and every compiled filter (SQL and parameters)
must be equal. The port's store also opens a ``metadata.sqlite`` (and
``ontology.sqlite``) the JAX package wrote and reads the same rows.
"""

import threading

import pytest

import sbeacon_tpu.metadata as jmeta
import sbeacon_tpu.metadata.filters as jfilters
import sbeacon_tpu_torch.metadata as pmeta
import sbeacon_tpu_torch.metadata.filters as pfilters

EDGES = [("HP:2", "HP:1"), ("HP:3", "HP:1"), ("HP:4", "HP:2")]

DOCS = {
    "datasets": [
        {"id": "ds1", "assemblyId": "GRCh38", "name": "One",
         "vcfLocations": ["a.vcf.gz"]},
        {"id": "ds2", "assemblyId": "grch38", "name": "Two",
         "vcfLocations": ["b.vcf.gz"]},
        {"id": "ds3", "assemblyId": "GRCh37", "name": "Three"},
    ],
    "individuals": [
        {"id": "i1", "datasetId": "ds1", "sex": {"id": "NCIT:C16576",
         "label": "female"}, "karyotypicSex": "XX",
         "diseases": [{"diseaseCode": {"id": "HP:4", "label": "leaf"}}]},
        {"id": "i2", "datasetId": "ds1", "sex": {"id": "NCIT:C20197",
         "label": "male"}, "karyotypicSex": "XY"},
        {"id": "i3", "datasetId": "ds2", "sex": {"id": "NCIT:C16576",
         "label": "female"}, "karyotypicSex": "XX",
         "diseases": [{"diseaseCode": {"id": "HP:3", "label": "mid"}}]},
    ],
    "biosamples": [
        {"id": "b1", "datasetId": "ds1", "individualId": "i1",
         "sampleOriginType": {"id": "UBERON:0000178", "label": "blood"}},
        {"id": "b2", "datasetId": "ds2", "individualId": "i3",
         "sampleOriginType": {"id": "UBERON:0000955", "label": "brain"}},
    ],
    "runs": [{"id": "r1", "datasetId": "ds1", "biosampleId": "b1",
              "individualId": "i1", "platform": "Illumina"}],
    "analyses": [{"id": "a1", "datasetId": "ds1", "runId": "r1",
                  "individualId": "i1", "biosampleId": "b1",
                  "vcfSampleId": "S0001"}],
    "cohorts": [{"id": "c1", "name": "Cohort 1"}],
}


def populate(mod, path=None, ontology_path=None):
    onto = (mod.OntologyStore(ontology_path) if ontology_path
            else mod.OntologyStore())
    onto.register_edges(EDGES)
    store = (mod.MetadataStore(path, ontology=onto) if path
             else mod.MetadataStore(ontology=onto))
    for kind, docs in DOCS.items():
        store.upsert(kind, [dict(d) for d in docs])
    store.rebuild_indexes()
    return store, onto


@pytest.fixture()
def twin():
    pair = (populate(jmeta), populate(pmeta))
    yield pair
    for store, onto in pair:
        store.close()
        onto.close()


FILTERS = [
    [],
    [{"id": "karyotypicSex", "operator": "=", "value": "XX"}],
    [{"id": "karyotypicSex", "operator": "!", "value": "XX"}],
    [{"id": "HP:2"}],
    [{"id": "HP:1"}],
    [{"id": "HP:2", "includeDescendantTerms": False}],
    [{"id": "HP:4", "similarity": "low"}],
    [{"id": "HP:4", "similarity": "medium"}],
    [{"id": "UBERON:0000178", "scope": "biosamples"}],
    [{"id": "Individual.karyotypicSex", "operator": "=", "value": "XY"}],
    [{"id": "NCIT:C16576"}, {"id": "HP:1"},
     {"id": "karyotypicSex", "operator": "=", "value": "XX"}],
    [{"id": "NCIT:C16576"}, {"id": "HP:1"},
     {"id": "karyotypicSex", "operator": "=", "value": "XX"},
     {"id": "UBERON:0000955", "scope": "biosamples"}],
    [{"id": "karyotypicSex", "operator": "=",
      "value": "x'; DROP TABLE individuals; --"}],
    [{"id": "EVIL:'; DROP TABLE relations; --"}],
]
KINDS = ["individuals", "datasets", "biosamples", "analyses"]


@pytest.mark.parametrize("filters", FILTERS, ids=range(len(FILTERS)))
@pytest.mark.parametrize("kind", KINDS)
def test_filter_sql_and_rows_equal(twin, kind, filters):
    (js, jo), (ps, po) = twin
    for scope in (kind, "individuals"):
        try:
            want = jfilters.entity_search_conditions(
                filters, kind, scope, ontology=jo)
        except jfilters.FilterError as e:
            with pytest.raises(pfilters.FilterError, match=str(e)[:20]):
                pfilters.entity_search_conditions(
                    filters, kind, scope, ontology=po)
            continue
        got = pfilters.entity_search_conditions(
            filters, kind, scope, ontology=po)
        assert got == want
    try:
        js.count(kind, filters)
    except jfilters.FilterError:
        with pytest.raises(pfilters.FilterError):
            ps.count(kind, filters)
        return
    assert ps.count(kind, filters) == js.count(kind, filters)
    assert ps.exists(kind, filters) == js.exists(kind, filters)
    for skip, limit in ((0, 100), (1, 2)):
        assert (ps.fetch(kind, filters, skip=skip, limit=limit)
                == js.fetch(kind, filters, skip=skip, limit=limit))


READS = {
    "extract_terms": lambda s, o, m: sorted(m.extract_terms({
        "id": "i1", "sex": {"id": "NCIT:C16576", "label": "female"},
        "diseases": [{"diseaseCode": {"id": "HP:4", "label": "leaf"},
                      "stage": {"id": "OGMS:0000119", "label": "acute"}}],
    })),
    "fetch_page": lambda s, o, m: s.fetch("individuals", limit=2, skip=1),
    "assembly": lambda s, o, m: s.datasets_for_assembly("GRCh38"),
    "assembly_ids": lambda s, o, m: s.datasets_for_assembly(
        "GRCh38", dataset_ids=["ds2"]),
    "terms": lambda s, o, m: s.filtering_terms(limit=100),
    "terms_page": lambda s, o, m: s.filtering_terms(limit=2, skip=1),
    "terms_kind": lambda s, o, m: s.filtering_terms(kinds=["individuals"]),
    "terms_dataset": lambda s, o, m: s.filtering_terms_for_entity(
        "datasets", "ds1"),
    "terms_cohort": lambda s, o, m: s.filtering_terms_for_entity(
        "cohorts", "c1"),
    "samples_i1": lambda s, o, m: s.sample_names_for_individual("i1"),
    "samples_i2": lambda s, o, m: s.sample_names_for_individual("i2"),
    "samples_b1": lambda s, o, m: s.sample_names_for_biosample("b1"),
    "samples_r1": lambda s, o, m: s.sample_names_for_run("r1"),
    "samples_a1": lambda s, o, m: s.sample_names_for_analysis("a1"),
    "entities_for_samples": lambda s, o, m: s.entities_for_samples(
        "individuals", "ds1", ["S0001", "S9"]),
    "relations_ds3": lambda s, o, m: s.query(
        "SELECT COUNT(*) FROM relations WHERE datasetid = 'ds3'"),
    "get_by_id": lambda s, o, m: [s.get_by_id(k, i) for k, i in (
        ("individuals", "i1"), ("datasets", "ds9"), ("cohorts", "c1"))],
    "cross_entity": lambda s, o, m: s.fetch(
        "biosamples", [], extra_where="individualid = ?",
        extra_params=["i3"]),
    "closures": lambda s, o, m: [
        sorted(o.term_ancestors("HP:4")), sorted(o.term_descendants("HP:1")),
        sorted(o.expand_filter_term("HP:2", similarity="medium")),
        sorted(o.expand_filter_term("HP:4", similarity="low"))],
}


@pytest.mark.parametrize("name", sorted(READS))
def test_reads_equal(twin, name):
    (js, jo), (ps, po) = twin
    assert READS[name](ps, po, pmeta) == READS[name](js, jo, jmeta)


def test_upserts_deletes_and_numeric_filters_equal(twin):
    (js, _jo), (ps, _po) = twin
    for store in (js, ps):
        store.upsert("individuals", [
            {"id": "i2", "datasetId": "ds1", "karyotypicSex": "XX",
             "sex": {"id": "NCIT:C20197", "label": "male"}}])
        store.upsert("cohorts", [
            {"id": "c2", "name": "Big", "cohortSize": 1000},
            {"id": "c3", "name": "Small", "cohortSize": 90}])
        store.rebuild_indexes()
        store.delete("individuals", "i3")
    f = [{"id": "karyotypicSex", "operator": "=", "value": "XX"}]
    assert ps.count("individuals", f) == js.count("individuals", f) == 2
    for op, v in (("<", 200), (">=", 200), ("!", 90)):
        f = [{"id": "cohortSize", "operator": op, "value": v}]
        assert ps.fetch("cohorts", f) == js.fetch("cohorts", f)
    assert (ps.count("individuals", [{"id": "HP:1"}])
            == js.count("individuals", [{"id": "HP:1"}]) == 1)


def test_filter_errors_equal():
    for filters, kind in (([{"value": "x"}], "individuals"),
                          ([{"id": "karyotypicSex", "operator": ">",
                             "value": "XX"}], "individuals"),
                          ([{"id": "x"}], "nonsense")):
        with pytest.raises(jfilters.FilterError) as je:
            jfilters.entity_search_conditions(filters, kind, "individuals")
        with pytest.raises(pfilters.FilterError) as pe:
            pfilters.entity_search_conditions(filters, kind, "individuals")
        assert str(pe.value) == str(je.value)


def test_ontology_resolver_hook():
    calls = []
    onto = pmeta.OntologyStore()

    def resolver(term):
        calls.append(term)
        return {"MONDO:ROOT"}

    onto.resolver = resolver
    assert onto.term_ancestors("MONDO:5") == {"MONDO:5", "MONDO:ROOT"}
    assert onto.term_ancestors("MONDO:5") == {"MONDO:5", "MONDO:ROOT"}
    assert calls == ["MONDO:5"]
    assert "MONDO:5" in onto.term_descendants("MONDO:ROOT")


def test_port_reads_a_jax_written_store(tmp_path):
    """The JAX package writes metadata.sqlite and ontology.sqlite; the
    port's store opens them and reads the same rows, terms and sample
    names as the JAX store reopened on the same files."""
    mdb, odb = tmp_path / "metadata.sqlite", tmp_path / "ontology.sqlite"
    store, onto = populate(jmeta, mdb, odb)
    store.close()
    onto.close()
    jo = jmeta.OntologyStore(odb)
    js = jmeta.MetadataStore(mdb, ontology=jo)
    po = pmeta.OntologyStore(odb)
    ps = pmeta.MetadataStore(mdb, ontology=po)
    try:
        for kind in KINDS + ["cohorts", "runs"]:
            assert ps.fetch(kind, limit=1000) == js.fetch(kind, limit=1000)
            for filters in FILTERS[1:6]:
                if kind == "individuals":
                    assert (ps.fetch(kind, filters)
                            == js.fetch(kind, filters))
        assert ps.filtering_terms() == js.filtering_terms()
        assert (ps.sample_names_for_individual("i1")
                == js.sample_names_for_individual("i1"))
        assert ps.query("SELECT A._datasetid, A._vcfsampleid FROM analyses "
                        "A") == [("ds1", "S0001")]
    finally:
        for s in (js, ps, jo, po):
            s.close()


def test_wal_reads_see_committed_writes_across_threads(tmp_path):
    """Per-thread WAL read connections of a file-backed store: a write
    on the main connection is visible to fresh and reused reader
    threads at once."""
    store = pmeta.MetadataStore(tmp_path / "m.sqlite")
    store.upsert("datasets", [{"id": "d1", "name": "first"}])
    for want in ("first", "second"):
        if want == "second":
            store.upsert("datasets", [{"id": "d1", "name": "second"}])
        seen = {}

        def reader(k):
            seen[k] = store.get_by_id("datasets", "d1")["name"]

        threads = [threading.Thread(target=reader, args=(k,))
                   for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert set(seen.values()) == {want}
    store.close()


def test_count_fast_path_matches_generic_in_both():
    """The precomputed term-count path agrees with the generic count,
    and the two packages agree, before and after a delete."""
    import random

    counts = []
    for mod in (jmeta, pmeta):
        rng = random.Random(71)
        onto = mod.OntologyStore()
        onto.register_edges([("HP:20", "HP:10"), ("HP:30", "HP:10"),
                             ("HP:21", "HP:20"), ("HP:22", "HP:20")])
        store = mod.MetadataStore(ontology=onto)
        store.upsert("datasets", [{"id": "d0", "name": "d"}])
        store.upsert("individuals", [
            {"id": f"i{i}", "datasetId": "d0",
             "sex": {"id": t, "label": t}}
            for i, t in enumerate(rng.choice(
                ["HP:20", "HP:30", "HP:21", "HP:22", "HP:99"])
                for _ in range(400))])
        store.rebuild_indexes()
        got = []
        for step in ("built", "deleted"):
            if step == "deleted":
                store.delete("individuals", "i7")
            for fid in ("HP:20", "HP:30", "HP:10", "HP:99", "HP:77"):
                for desc in (True, False):
                    filters = [{"id": fid, "includeDescendantTerms": desc}]
                    where, params = store._compile(filters, "individuals")
                    generic = int(store._read(
                        f"SELECT COUNT(*) FROM individuals {where}",
                        params)[0][0])
                    fast = store.count("individuals", filters)
                    assert fast == generic, (fid, desc, step)
                    got.append(fast)
        counts.append(got)
        store.close()
        onto.close()
    assert counts[0] == counts[1]
    assert sum(c > 0 for c in counts[1]) >= 10


def test_ontology_store_serves_concurrent_readers_and_a_writer(tmp_path):
    """One sqlite connection, many threads: concurrent term expansions
    (the filter compiler's reads) beside edge registrations answer
    every read, with no InterfaceError, under a 1 us switch interval."""
    import sys

    onto = pmeta.OntologyStore(tmp_path / "ontology.sqlite")
    onto.register_edges([(f"HP:{i:04d}", "HP:9999") for i in range(40)])
    errors, done = [], []
    stop = threading.Event()

    def reader(k):
        try:
            while not stop.is_set():
                got = onto.expand_filter_term("HP:9999")
                assert {"HP:9999", "HP:0000"} <= got
                assert onto.term_ancestors(f"HP:{k % 40:04d}") >= {
                    "HP:9999"}
            done.append(k)
        except Exception as e:  # reported below, with its type
            errors.append(e)

    def writer():
        try:
            for i in range(40, 120):
                onto.register_edges([(f"HP:{i:04d}", "HP:9999")])
        except Exception as e:
            errors.append(e)
        finally:
            stop.set()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=reader, args=(k,))
                   for k in range(16)] + [threading.Thread(target=writer)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
        assert len(done) == 16
        # every registration landed
        assert onto.term_descendants("HP:9999") == (
            {f"HP:{i:04d}" for i in range(120)} | {"HP:9999"})
    finally:
        sys.setswitchinterval(old)
        stop.set()
        onto.close()
