"""The port's pod dispatch tier held against the JAX package's.

Mirrors the tier tests of tests/test_mesh_dispatch.py. The JAX tier
(``MeshDispatchTier(engine, devices=jax.devices()[:n])``) runs its
single launch on n of the suite's eight forced CPU devices; the port's
tier runs on a mesh of n CPU entries (``devices=[cpu] * n``), where the
owner-sliced fused query and the ring gather run their plain-PyTorch
twins. Both engines hold the same seeded shards (built by the JAX
package); every response must equal the JAX tier's and the JAX engine's
without mesh, micro-batcher or tier (``use_mesh=False,
mesh_dispatch=False, microbatch=False``), field for field: tolerance 0.
"""

import dataclasses
import random

import jax
import pytest
import torch

from sbeacon_tpu.config import BeaconConfig as JBeaconConfig
from sbeacon_tpu.config import EngineConfig as JEngineConfig
from sbeacon_tpu.engine import VariantEngine as JVariantEngine
from sbeacon_tpu.index.columnar import build_index as j_build_index
from sbeacon_tpu.parallel.dispatch import MeshDispatchTier as JTier
from sbeacon_tpu.payloads import VariantQueryPayload as JPayload
from sbeacon_tpu.testing import random_records as j_random_records
from sbeacon_tpu_torch.config import BeaconConfig, EngineConfig
from sbeacon_tpu_torch.engine import VariantEngine
from sbeacon_tpu_torch.index import shard_from_reference
from sbeacon_tpu_torch.parallel import mesh as tm
from sbeacon_tpu_torch.parallel.dispatch import MeshDispatchTier
from sbeacon_tpu_torch.payloads import VariantQueryPayload
from torch_ingest_corpus import no_thread_leak  # noqa: F401

CPU = torch.device("cpu")
DS = ["d0", "d1", "d2", "d3"]


def _shards(n=4, gt_only=()):
    """test_mesh_dispatch.py's corpus (two samples, chromosome 1); the
    shards named in ``gt_only`` keep the gt plane alone."""
    out = []
    for d in range(n):
        rng = random.Random(40 + d)
        recs = j_random_records(rng, chrom="1", n=250, n_samples=2,
                                p_no_acan=0.4)
        s = j_build_index(recs, dataset_id=f"d{d}", vcf_location=f"v{d}",
                          sample_names=["S0", "S1"])
        if d in gt_only:
            s = dataclasses.replace(s, gt_bits2=None, tok_bits1=None,
                                    tok_bits2=None)
        out.append(s)
    return out


def _late(seed=123, name="late2"):
    return j_build_index(
        j_random_records(random.Random(seed), chrom="1", n=80, n_samples=2),
        dataset_id=name, vcf_location=f"{name}.vcf.gz",
        sample_names=["S0", "S1"])


@pytest.fixture
def setup():
    """A factory of (port engine, port tier, JAX engine, JAX tier, JAX
    reference engine) over the same shards, closed at the end."""
    made = []

    def make(n_mesh=2, shards=None, **over):
        shards = shards or _shards()
        teng = VariantEngine(BeaconConfig(engine=EngineConfig(
            use_mesh=False, microbatch_wait_ms=0.0, **over)), device="cpu")
        jeng = JVariantEngine(JBeaconConfig(engine=JEngineConfig(
            use_mesh=False, microbatch_wait_ms=0.0, response_cache=False,
            **over)))
        jref = JVariantEngine(JBeaconConfig(engine=JEngineConfig(
            use_mesh=False, mesh_dispatch=False, microbatch=False,
            response_cache=False)))
        for s in shards:
            teng.add_index(shard_from_reference(s))
            jeng.add_index(s)
            jref.add_index(s)
        tier = MeshDispatchTier(teng, devices=[CPU] * n_mesh)
        jtier = JTier(jeng, devices=jax.devices()[:n_mesh])
        made.append((tier, jtier, teng, jeng, jref))
        return teng, tier, jeng, jtier, jref

    yield make
    for objs in made:
        for o in objs:
            o.close()


def _doc(datasets=DS, gran="count", include="HIT", **kw):
    return dict(dataset_ids=list(datasets), reference_name="1", start_min=1,
                start_max=1 << 29, end_min=1, end_max=1 << 30,
                alternate_bases="N", requested_granularity=gran,
                include_datasets=include, **kw)


def _same(tier, jtier, jref, doc):
    """The port tier's responses equal the JAX tier's and the reference
    engine's; returns them."""
    ds = set(doc["dataset_ids"])
    got = tier.search(VariantQueryPayload(**doc), ds)
    want = jtier.search(JPayload(**doc), ds)
    ref = jref.search(JPayload(**doc))
    asd = lambda rs: [dataclasses.asdict(r) for r in rs]
    assert asd(got) == asd(want), doc
    assert asd(got) == asd(ref), doc
    return got


MODES = {
    "plain": {},
    "selected": dict(selected_samples_only=True,
                     sample_names={d: ["S1"] for d in DS}),
    "extract": dict(include_samples=True),
}


@pytest.mark.parametrize("n_mesh", [2, 3, 8])
@pytest.mark.parametrize("gran", ["boolean", "count", "record"])
@pytest.mark.parametrize("include", ["HIT", "ALL"])
@pytest.mark.parametrize("mode", list(MODES))
def test_search_matches_jax(setup, n_mesh, gran, include, mode):
    teng, tier, _jeng, jtier, jref = setup(n_mesh)
    assert tier.warmup() > 0
    assert jtier._ready(wait=True) is not None
    doc = _doc(gran=gran, include=include, **MODES[mode])
    assert tier.resolve(DS, VariantQueryPayload(**doc)) == set(DS)
    got = _same(tier, jtier, jref, doc)
    assert any(r.exists for r in got)
    st = tier.stats()
    assert st["dispatches"] == 1 and st["ready"] and st["planes"]
    assert st["devices"] == n_mesh and st["shards"] == 4


@pytest.mark.parametrize("mode", ["selected", "extract"])
def test_count_plane_mismatch_drops_the_fused_triple(setup, mode):
    """One shard lacks count planes, so the stack has none: a
    selected-samples query on a shard WITH count planes takes the plane
    index, not the fused triple; answers still equal JAX's."""
    teng, tier, _jeng, jtier, jref = setup(2, _shards(gt_only=(2,)))
    tier.warmup()
    jtier._ready(wait=True)
    assert not tier._state[0].has_count_planes
    for gran in ("count", "record"):
        _same(tier, jtier, jref, _doc(gran=gran, include="ALL",
                                      **MODES[mode]))


def test_tier_rides_microbatcher(setup):
    """A 4-target query lands as one 4-spec submit_many entry."""
    teng, tier, *_ = setup(2)
    tier.warmup()
    tier.search(VariantQueryPayload(**_doc()), set(DS))
    assert 4 in teng.batcher.occupancy()["fused_hist"]
    tier.search(VariantQueryPayload(**_doc(**MODES["selected"])), set(DS))
    occ = teng.batcher.occupancy()
    assert occ["fused_hist"] == {4: 2} and occ["launches"] == 2
    assert tier.stats()["dispatches"] == 2


def test_refusal_reasons_are_counted(setup):
    teng, tier, *_ = setup(2)
    pay = VariantQueryPayload(**_doc())
    assert tier.resolve(DS, pay) == set()  # nothing built yet
    assert tier.stats()["refusals"].get("unbuilt", 0) >= 1
    assert tier.warmup() > 0
    assert tier.resolve(["d0"], VariantQueryPayload(**_doc(["d0"]))) == set()
    assert tier.stats()["refusals"].get("min_shards", 0) == 1
    # an N inside the ref needs host regex semantics: the plane leg refuses
    wild = VariantQueryPayload(**_doc(gran="record", include="ALL",
                                      reference_bases="AN",
                                      **MODES["selected"]))
    assert tier.resolve(DS, wild) == set()
    assert tier.stats()["refusals"].get("planes", 0) == 1
    teng.add_index(shard_from_reference(_late()))
    assert tier.resolve(DS, pay) == set()
    assert tier.stats()["refusals"].get("stale", 0) >= 1


@pytest.mark.parametrize("n_mesh", [2, 3])
def test_plane_reservation_registered_and_released(setup, n_mesh):
    """Every mesh entry on the engine's device ([cpu] * n here, as
    [card, card] on one GPU) holds its own block's planes, so the ledger
    carries n_mesh times the per-entry bytes; close releases them."""
    teng, tier, *_ = setup(n_mesh)
    before = teng.plane_hbm_resident()
    tier.warmup()
    per_entry = tier._state[0].plane_bytes_device
    assert per_entry > 0 and tier.stats()["planes"]
    assert teng.plane_hbm_resident() == before + n_mesh * per_entry
    tier.close()
    assert teng.plane_hbm_resident() == before
    assert tier.resolve(DS, VariantQueryPayload(**_doc())) == set()


def test_reservation_counts_only_the_engines_device(setup):
    """Entries on another device are outside the engine's budget."""
    _teng, tier, *_ = setup(2)
    mesh = tm.make_mesh(devices=[CPU, torch.device("meta"), CPU])
    assert tier._entries_on_engine(mesh) == 2


def test_no_room_builds_without_planes(setup):
    teng, tier, *_ = setup(2, plane_hbm_budget_gb=1e-9)
    tier.warmup()
    assert tier.stats()["ready"] and not tier.stats()["planes"]
    assert teng.plane_hbm_resident() == 0
    sel = VariantQueryPayload(**_doc(**MODES["selected"]))
    assert tier.resolve(DS, sel) == set()
    assert tier.stats()["refusals"] == {"planes": 1}


def test_tier_goes_cold_after_add_index_and_rebuilds(setup):
    teng, tier, _jeng, jtier, jref = setup(2)
    tier.warmup()
    fp = tier.stats()["fingerprint"]
    assert fp == teng.base_fingerprint() == teng.index_fingerprint()
    late = _late(5, "late3")
    teng.add_index(shard_from_reference(late))
    jtier.engine.add_index(late)
    jref.add_index(late)
    assert tier._ready() is None  # stale: a background rebuild is armed
    for t in list(tier._builds):
        t.join()
    assert tier.stats()["shards"] == 5 and tier.stats()["fingerprint"] != fp
    jtier._ready(wait=True)
    _same(tier, jtier, jref, _doc(DS + ["late3"], gran="record"))


def test_fingerprint_matches_jax(setup):
    teng, _tier, jeng, *_ = setup(2)
    assert teng.base_fingerprint() == jeng.base_fingerprint()
    assert teng.index_fingerprint() == jeng.index_fingerprint()
    assert [(k, s.n_rows) for k, s in teng.shard_snapshot()] == [
        (k, s.n_rows) for k, s in jeng.shard_snapshot()]
    assert [k for k, _s, _p in teng.index_snapshot()] == [
        k for k, _s, _p in jeng.index_snapshot()]


def test_unavailable_on_a_one_entry_mesh(setup, monkeypatch):
    teng, _tier, *_ = setup(2)
    one = MeshDispatchTier(teng, devices=[CPU])
    assert not one.available() and one.warmup() == 0
    assert one.resolve(DS, VariantQueryPayload(**_doc())) == set()
    assert one.stats()["refusals"] == {"unbuilt": 1}
    # without devices the engine's mesh decides: one entry on a CPU engine
    assert not MeshDispatchTier(teng).available()
    monkeypatch.setattr(tm, "mesh_devices", lambda device: [CPU] * 2)
    assert MeshDispatchTier(teng).available()


def test_too_few_shards_declines(setup):
    teng, tier, *_ = setup(2, shards=_shards(1))
    assert tier.warmup() == 0 and not tier.stats()["ready"]


def test_failed_build_raises_and_releases(setup, monkeypatch):
    """No fallback: an inline build failure raises; a background one is
    raised by the next consults, and the plane reservation is rolled
    back."""
    teng, tier, *_ = setup(2)
    before = teng.plane_hbm_resident()

    class Broken(tm.MeshFusedIndex):
        def __init__(self, *a, **k):
            raise RuntimeError("upload failed")

    monkeypatch.setattr(tm, "MeshFusedIndex", Broken)
    with pytest.raises(RuntimeError, match="upload failed"):
        tier.warmup()
    assert teng.plane_hbm_resident() == before
    pay = VariantQueryPayload(**_doc())
    with pytest.raises(RuntimeError, match="failed to build"):
        tier.resolve(DS, pay)


def test_search_refuses_keys_outside_the_stack(setup):
    """A served key the stack does not hold (published after the build)
    is not refused any more: the tier answers it on its tail leg, after
    the stacked keys, as the JAX tier does."""
    teng, tier, jeng, jtier, _jref = setup(2)
    tier.warmup()
    assert jtier._ready(wait=True) is not None
    late = j_build_index(
        j_random_records(random.Random(9), chrom="1", n=30, n_samples=2),
        dataset_id="d0", vcf_location="v0b", sample_names=["S0", "S1"])
    teng.add_index(shard_from_reference(late))
    jeng.add_index(late)
    got = tier.search(VariantQueryPayload(**_doc()), set(DS))
    want = jtier.search(JPayload(**_doc()), set(DS))
    asd = lambda rs: [dataclasses.asdict(r) for r in rs]
    assert asd(got) == asd(want)
    assert [r.vcf_location for r in got][-1] == "v0b"


def test_config_knobs_default_as_jax(setup):
    """mesh_min_shards defaults as JAX's and is the tier's default; the
    layout is the tier's argument (owner-sharded by default)."""
    t, j = EngineConfig(), JEngineConfig()
    assert t.mesh_min_shards == j.mesh_min_shards
    teng, tier, *_ = setup(2, mesh_min_shards=3)
    assert tier.min_shards == 3 and tier.layout == tm.LAYOUT_OWNER
    assert MeshDispatchTier(teng, min_shards=1).min_shards == 1
