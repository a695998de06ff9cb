"""The port engine's mesh leg held against the JAX engine's.

Mirrors the engine tests of tests/test_mesh_serving.py. The JAX engine
runs its mesh leg (``use_mesh`` on) on the suite's eight forced CPU
devices; the port engine runs on ``device="cpu"`` with
``parallel.mesh.mesh_devices`` patched to eight CPU entries, its
counterpart of the forced devices (the engine takes the mesh only at two
or more devices, as JAX does), so the stacked kernels' wrappers run
their plain-PyTorch twins. The same seeded shards (built by the JAX
package) go into both; every response must equal the JAX engine's field
for field (integers and strings: tolerance 0).
"""

import dataclasses
import random
import threading
import time

import pytest
import torch

from sbeacon_tpu.config import BeaconConfig as JBeaconConfig
from sbeacon_tpu.config import EngineConfig as JEngineConfig
from sbeacon_tpu.engine import VariantEngine as JVariantEngine
from sbeacon_tpu.index.columnar import build_index as j_build_index
from sbeacon_tpu.payloads import VariantQueryPayload as JPayload
from sbeacon_tpu.testing import random_records as j_random_records
from sbeacon_tpu_torch.config import BeaconConfig, EngineConfig
from sbeacon_tpu_torch.engine import VariantEngine
from sbeacon_tpu_torch.index import shard_from_reference
from sbeacon_tpu_torch.parallel import mesh as tm
from sbeacon_tpu_torch.payloads import VariantQueryPayload
from torch_ingest_corpus import no_thread_leak  # noqa: F401

CPU = torch.device("cpu")
SAMPLES = ["S0", "S1", "S2"]


@pytest.fixture
def eight_devices(monkeypatch):
    """The port's mesh lists eight CPU entries."""
    monkeypatch.setattr(tm, "mesh_devices", lambda device: [CPU] * 8)


@pytest.fixture
def engines(eight_devices):
    """A factory of (port engine, JAX engine) pairs over the same shards,
    closed at the end of the test."""
    made = []

    def make(shards, *, jax_mesh=True, **over):
        teng = VariantEngine(BeaconConfig(engine=EngineConfig(
            microbatch=False, **over)), device="cpu")
        jeng = JVariantEngine(JBeaconConfig(engine=JEngineConfig(
            microbatch=False, response_cache=False,
            **{"use_mesh": jax_mesh, **over})))
        made.append((teng, jeng))
        for s in shards:
            add(teng, jeng, s)
        return teng, jeng

    yield make
    for teng, jeng in made:
        teng.close()
        jeng.close()


def add(teng, jeng, shard):
    jeng.add_index(shard)
    teng.add_index(shard_from_reference(shard))


def _shards(n_ds=5, *, n=400, seed0=300, names=SAMPLES, **kw):
    out = []
    for d in range(n_ds):
        rng = random.Random(seed0 + d)
        recs = j_random_records(rng, chrom="7", n=n, n_samples=len(names),
                                **kw)
        out.append(j_build_index(recs, dataset_id=f"d{d}",
                                 vcf_location=f"v{d}.vcf.gz",
                                 sample_names=names))
    return out


def _genotype_derived_shards(n_ds=4, seed0=900):
    """Genotype-derived corpora: restricted counting comes from the
    planes, ploidy > 2 rows from the host side tables."""
    names = [f"S{i}" for i in range(7)]
    out = []
    for d in range(n_ds):
        rng = random.Random(seed0 + d)
        recs = j_random_records(rng, chrom="7", n=250, n_samples=len(names),
                                p_multiallelic=0.3, p_no_acan=0.6)
        for rec in recs[::9]:
            rec.genotypes[rng.randrange(len(names))] = "1|1|1"
            rec.ac = None
            rec.an = None
        out.append(j_build_index(recs, dataset_id=f"d{d}",
                                 vcf_location=f"v{d}.vcf.gz",
                                 sample_names=names))
    return out


def _doc(**kw):
    base = dict(
        dataset_ids=[],
        reference_name="7",
        start_min=1,
        start_max=1 << 30,
        end_min=1,
        end_max=1 << 30,
        alternate_bases="N",
        include_datasets="HIT",
        requested_granularity="record",
    )
    base.update(kw)
    return base


def _same(teng, jeng, doc):
    """Both engines' responses to ``doc``, asserted equal field for
    field; returns the port's."""
    got = teng.search(VariantQueryPayload(**doc))
    want = jeng.search(JPayload(**doc))
    assert [dataclasses.asdict(r) for r in got] == [
        dataclasses.asdict(r) for r in want], doc
    return got


def test_use_mesh_defaults_on():
    assert EngineConfig().use_mesh is True


def test_mesh_engages_and_matches_jax(engines):
    teng, jeng = engines(_shards())
    got = _same(teng, jeng, _doc())
    assert teng.mesh_searches == 1 and jeng.mesh_searches == 1
    assert any(r.exists for r in got)
    assert teng.fused_searches == 0  # the mesh leg served every target


def test_mesh_dataset_subset_and_single_target(engines):
    teng, jeng = engines(_shards())
    _same(teng, jeng, _doc(dataset_ids=["d1", "d3"]))
    assert teng.mesh_searches == 1
    # single-target queries stay on the per-dataset path
    _same(teng, jeng, _doc(dataset_ids=["d2"]))
    assert teng.mesh_searches == 1


def test_mesh_overflow_falls_back_to_host_rows(engines):
    teng, jeng = engines(_shards(), window_cap=16, record_cap=8)
    got = _same(teng, jeng, _doc())
    assert teng.mesh_searches == 1
    assert sum(len(r.variants) for r in got) > 8


def test_mesh_selected_samples_parity(engines):
    teng, jeng = engines(_shards())
    _same(teng, jeng, _doc(
        selected_samples_only=True,
        sample_names={f"d{d}": ["S0", "S2"] for d in range(5)},
        include_samples=True,
    ))
    assert teng.mesh_searches == 1 and teng.mesh_selected_searches == 1


def test_mesh_point_and_type_queries_parity(engines):
    shards = _shards()
    teng, jeng = engines(shards)
    rng = random.Random(9)
    pos = shards[0].cols["pos"]
    for k in range(12):
        p = int(pos[rng.randrange(len(pos))])
        _same(teng, jeng, _doc(
            start_min=p, start_max=p, alternate_bases=None,
            variant_type=rng.choice(["DEL", "INS", "DUP", "CNV", "INV",
                                     None]),
            requested_granularity=("boolean", "count", "record")[k % 3],
        ))
    assert teng.mesh_searches == 12


def test_reingestion_invalidates_mesh_stack(engines):
    teng, jeng = engines(_shards(n_ds=3))
    _same(teng, jeng, _doc())
    rng = random.Random(999)
    late = j_build_index(
        j_random_records(rng, chrom="7", n=200, n_samples=len(SAMPLES)),
        dataset_id="late", vcf_location="late.vcf.gz", sample_names=SAMPLES)
    add(teng, jeng, late)
    assert teng._mesh_dirty
    got = _same(teng, jeng, _doc())
    assert {r.dataset_id for r in got} == {"d0", "d1", "d2", "late"}
    assert teng.mesh_searches == 2


def test_mesh_vs_oracle_aggregates(engines):
    """Mesh-leg responses equal the JAX package's CPU oracle record by
    record."""
    from sbeacon_tpu.oracle import oracle_search

    teng, _jeng = engines(_shards(n_ds=3, n=150))
    got = teng.search(VariantQueryPayload(**_doc(start_max=40_000)))
    assert teng.mesh_searches == 1
    for d in range(3):
        recs = j_random_records(random.Random(300 + d), chrom="7", n=150,
                                n_samples=len(SAMPLES))
        want = oracle_search(
            recs, first_bp=1, last_bp=40_000, end_min=1, end_max=1 << 30,
            reference_bases=None, alternate_bases="N",
            requested_granularity="record", include_details=True,
            dataset_id=f"d{d}", chrom_label="7",
        )
        r = next(r for r in got if r.dataset_id == f"d{d}")
        assert (r.exists, r.call_count, r.all_alleles_count) == (
            want.exists, want.call_count, want.all_alleles_count)


def test_concurrent_queries_during_reingestion(eight_devices):
    """Queries racing add_index: no exceptions, every response
    consistent (the mesh state never pairs a stack with replaced
    shards)."""
    teng = VariantEngine(BeaconConfig(engine=EngineConfig(microbatch=False)),
                         device="cpu")
    try:
        for s in _shards(n_ds=4, n=250):
            teng.add_index(shard_from_reference(s))
        payload = VariantQueryPayload(**_doc())
        stop = threading.Event()
        errors: list[BaseException] = []

        def churn():
            k = 0
            while not stop.is_set():
                recs = j_random_records(random.Random(500 + k), chrom="7",
                                        n=150 + (k % 3) * 40,
                                        n_samples=len(SAMPLES))
                teng.add_index(shard_from_reference(j_build_index(
                    recs, dataset_id=f"d{k % 4}",
                    vcf_location=f"v{k % 4}.vcf.gz", sample_names=SAMPLES)))
                k += 1

        def query():
            while not stop.is_set():
                try:
                    rs = teng.search(payload)
                    assert len(rs) == 4
                    for r in rs:
                        assert r.call_count >= 0 and r.all_alleles_count >= 0
                except BaseException as e:  # noqa: BLE001
                    errors.append(e)
                    return

        threads = [threading.Thread(target=churn)] + [
            threading.Thread(target=query) for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(2.0)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
        rs = teng.search(payload)
        assert {r.dataset_id for r in rs} == {"d0", "d1", "d2", "d3"}
        assert teng.mesh_searches > 0
    finally:
        teng.close()


@pytest.mark.parametrize("gran", ["record", "count", "boolean"])
def test_mesh_serves_selected_samples_as_one_program(engines, gran):
    """A multi-dataset selected-samples query runs the stacked selected
    kernel (mesh_selected_searches increments) on genotype-derived
    corpora, at every granularity with and without details, and on
    narrow windows."""
    shards = _genotype_derived_shards()
    teng, jeng = engines(shards)
    for details in (True, False):
        before = teng.mesh_selected_searches
        _same(teng, jeng, _doc(
            selected_samples_only=True,
            sample_names={f"d{d}": ["S0", "S3", "S6"] for d in range(4)},
            include_samples=True, requested_granularity=gran,
            include_datasets="HIT" if details else "NONE",
        ))
        assert teng.mesh_selected_searches == before + 1
    rng = random.Random(5)
    pos = shards[0].cols["pos"]
    for _ in range(4):
        p = int(pos[rng.randrange(len(pos))])
        _same(teng, jeng, _doc(
            start_min=max(1, p - 200), start_max=p + 200,
            selected_samples_only=True, requested_granularity=gran,
            sample_names={f"d{d}": ["S1", "S4"] for d in range(4)},
            include_samples=True,
        ))
    assert jeng.mesh_selected_searches == teng.mesh_selected_searches


def test_mesh_selected_heterogeneous_sample_widths(engines):
    """Shards of 1, 2 and 3 plane words: or_words come back stack-wide
    and truncate to each shard's own width."""
    widths = [3, 40, 70]
    shards = []
    for d, n_samples in enumerate(widths):
        names = [f"S{i}" for i in range(n_samples)]
        recs = j_random_records(random.Random(700 + d), chrom="7", n=200,
                                n_samples=n_samples, p_no_acan=0.5)
        shards.append(j_build_index(recs, dataset_id=f"d{d}",
                                    vcf_location=f"v{d}.vcf.gz",
                                    sample_names=names))
    teng, jeng = engines(shards)
    _same(teng, jeng, _doc(
        selected_samples_only=True,
        sample_names={f"d{d}": [f"S{i}" for i in range(0, w, max(1, w // 4))]
                      for d, w in enumerate(widths)},
        include_samples=True,
    ))
    assert teng.mesh_selected_searches == 1


def test_sample_extraction_reads_the_plane_index(engines):
    """Sample-hit extraction without selected samples rides the
    query-only kernel and reads each dataset's device planes."""
    teng, jeng = engines(_shards(n_ds=3))
    _same(teng, jeng, _doc(include_samples=True))
    assert teng.mesh_searches == 1 and teng.mesh_selected_searches == 0


def test_budget_gate_declines_the_stack_planes(engines):
    """Past the plane budget the stack goes up without planes: a
    selected-samples query then rides the query-only kernel and
    materialises from the host planes, with the JAX engine's answers."""
    teng, jeng = engines(_genotype_derived_shards(n_ds=3),
                         plane_hbm_budget_gb=1e-9)
    doc = _doc(selected_samples_only=True, include_samples=True,
               sample_names={f"d{d}": ["S0", "S5"] for d in range(3)})
    _same(teng, jeng, doc)
    verdict = teng._plane_budget_verdict
    assert verdict["fits"] is False and verdict["headroomBytes"] < 0
    assert teng._mesh_state[1].has_planes is False
    assert teng.mesh_searches == 1 and teng.mesh_selected_searches == 0


def test_budget_gate_admits_the_stack_planes(engines):
    teng, jeng = engines(_genotype_derived_shards(n_ds=3))
    _same(teng, jeng, _doc(selected_samples_only=True,
                           sample_names={f"d{d}": ["S2"] for d in range(3)}))
    verdict = teng._plane_budget_verdict
    assert verdict["fits"] is True
    # the eight entries are all the engine's CPU: eight blocks' planes
    assert verdict["perDeviceBytes"] == 8 * tm.StackedIndex.plane_bytes_per_device(
        teng._mesh_state[1].shards, n_datasets_padded=8, n_mesh=8)


@pytest.mark.parametrize("factor,fits", [(1.5, False), (2.5, True)])
def test_budget_counts_each_entry_on_the_engines_device(monkeypatch, factor,
                                                        fits):
    """A mesh that lists the engine's device twice holds both entries'
    blocks there: a budget between one entry's plane bytes and two
    refuses the stack's planes, one above two admits them, and the
    answers equal the JAX engine's either way."""
    shards = _genotype_derived_shards(n_ds=4)
    per_dev = tm.StackedIndex.plane_bytes_per_device(
        [shard_from_reference(s) for s in shards], n_datasets_padded=4,
        n_mesh=2)
    monkeypatch.setattr(tm, "mesh_devices", lambda device: [CPU, CPU])
    teng = VariantEngine(BeaconConfig(engine=EngineConfig(
        microbatch=False, plane_hbm_budget_gb=factor * per_dev / 1e9)),
        device="cpu")
    jeng = JVariantEngine(JBeaconConfig(engine=JEngineConfig(
        microbatch=False, response_cache=False, use_mesh=True)))
    try:
        for s in shards:
            add(teng, jeng, s)
        assert teng.plane_hbm_resident() < per_dev // 2
        doc = _doc(selected_samples_only=True, include_samples=True,
                   sample_names={f"d{d}": ["S0", "S5"] for d in range(4)})
        _same(teng, jeng, doc)
        verdict = teng._plane_budget_verdict
        assert verdict["perDeviceBytes"] == 2 * per_dev
        assert verdict["fits"] is fits
        assert teng._mesh_state[1].has_planes is fits
        assert teng.mesh_selected_searches == int(fits)
    finally:
        teng.close()
        jeng.close()


def test_entries_on_counts_the_devices_copies():
    """Distinct devices keep one entry's bytes each."""
    mesh = tm.Mesh([CPU, torch.device("meta"), CPU])
    assert tm.entries_on(mesh, CPU) == 2
    assert tm.entries_on(mesh, "meta") == 1
    assert tm.entries_on(tm.Mesh([torch.device("meta")] * 2), CPU) == 0


@pytest.mark.parametrize("kernel,selected", [("stacked_query", False),
                                             ("stacked_selected", True)])
def test_failed_launch_raises_from_search(engines, monkeypatch, kernel,
                                          selected):
    """A raising kernel wrapper raises from search: the mesh leg never
    falls back to the other legs."""
    teng, _jeng = engines(_shards(n_ds=3))

    def boom(*_a, **_k):
        raise RuntimeError(f"{kernel} launch failed: CUDA error 700")

    monkeypatch.setattr(tm, kernel, boom)
    doc = _doc(selected_samples_only=selected,
               sample_names={f"d{d}": ["S1"] for d in range(3)})
    with pytest.raises(RuntimeError, match="launch failed"):
        teng.search(VariantQueryPayload(**doc))
    assert teng.mesh_searches == 0 and teng.fused_searches == 0


def test_failed_build_raises_until_a_build_succeeds(engines, monkeypatch):
    teng, jeng = engines(_shards(n_ds=3))

    def boom(*_a, **_k):
        raise MemoryError("device out of memory")

    monkeypatch.setattr(tm.StackedIndex, "shard_to_mesh", boom)
    payload = VariantQueryPayload(**_doc())
    for _ in range(2):
        with pytest.raises(MemoryError):
            teng.search(payload)
    single = VariantQueryPayload(**_doc(dataset_ids=["d0"]))
    assert len(teng.search(single)) == 1  # one dataset needs no stack
    monkeypatch.undo()
    monkeypatch.setattr(tm, "mesh_devices", lambda device: [CPU] * 8)
    _same(teng, jeng, _doc())
    assert teng.mesh_searches == 1


def test_stale_stack_serves_a_late_dataset_elsewhere(engines, monkeypatch):
    """A dataset published after the stack was built is not in the
    stack: the other legs serve it, and the responses come back in
    sorted order."""
    teng, jeng = engines(_shards(n_ds=3))
    state = teng._mesh_ready()
    late = j_build_index(
        j_random_records(random.Random(41), chrom="7", n=120,
                         n_samples=len(SAMPLES)),
        dataset_id="a_late", vcf_location="late.vcf.gz",
        sample_names=SAMPLES)
    add(teng, jeng, late)
    monkeypatch.setattr(teng, "_mesh_ready", lambda: state)
    got = _same(teng, jeng, _doc())
    assert [r.dataset_id for r in got] == ["a_late", "d0", "d1", "d2"]
    assert teng.mesh_searches == 1


def test_one_device_keeps_the_fused_leg():
    """Without the patch a CPU engine's mesh has one entry: the mesh
    leg stays off and the fused stack serves, as the JAX engine on one
    chip."""
    shards = _shards(n_ds=3)
    jeng = JVariantEngine(JBeaconConfig(engine=JEngineConfig(
        microbatch=False, use_mesh=False, response_cache=False)))
    teng = VariantEngine(BeaconConfig(engine=EngineConfig(microbatch=False)),
                         device="cpu")
    try:
        for s in shards:
            add(teng, jeng, s)
        assert teng.warm_fused() is not None
        _same(teng, jeng, _doc())
        assert teng._mesh_ready() is None
        assert teng.mesh_searches == 0 and teng.fused_searches == 1
    finally:
        teng.close()
        jeng.close()


def test_use_mesh_off_keeps_the_fused_leg(engines):
    teng, jeng = engines(_shards(n_ds=3), use_mesh=False)
    assert teng.warm_fused() is not None
    _same(teng, jeng, _doc())
    assert teng.mesh_searches == 0 and teng.fused_searches == 1
    assert teng._mesh_ready() is None
