"""The port's engine, API parsing and envelopes held against the JAX package.

The JAX package builds the seeded shards; ``shard_from_reference``
hands the same arrays to the port. The JAX ``VariantEngine`` (mesh and
response cache off, XLA on the CPU) and the port's ``VariantEngine`` on
``device="cpu"`` must give equal ``dataclasses.asdict`` of every
response, and ``run_variant_search`` + envelopes byte-identical JSON.
All outputs are integers and strings: the tolerance is 0.
"""

import dataclasses
import json
import random
import threading

import numpy as np
import pytest

from sbeacon_tpu.api.envelopes import Envelopes as JEnvelopes
from sbeacon_tpu.api.requests import RequestError as JRequestError
from sbeacon_tpu.api.requests import parse_request as j_parse_request
from sbeacon_tpu.api.variants import run_variant_search as j_run_variant_search
from sbeacon_tpu.config import BeaconConfig as JBeaconConfig
from sbeacon_tpu.config import BeaconInfo as JBeaconInfo
from sbeacon_tpu.config import EngineConfig as JEngineConfig
from sbeacon_tpu.engine import VariantEngine as JVariantEngine
from sbeacon_tpu.genomics.vcf import VcfRecord as JVcfRecord
from sbeacon_tpu.index import build_index as j_build_index
from sbeacon_tpu.payloads import VariantQueryPayload as JPayload
from sbeacon_tpu.testing import random_records as j_random_records
from sbeacon_tpu_torch import testing as t_testing
from sbeacon_tpu_torch.api.envelopes import Envelopes
from sbeacon_tpu_torch.api.requests import RequestError, parse_request
from sbeacon_tpu_torch.api.variants import run_variant_search
from sbeacon_tpu_torch.config import BeaconConfig, BeaconInfo, EngineConfig
from sbeacon_tpu_torch.engine import VariantEngine
from sbeacon_tpu_torch.index import build_index, shard_from_reference
from sbeacon_tpu_torch.payloads import VariantQueryPayload
from torch_ingest_corpus import no_thread_leak  # noqa: F401


def _records():
    rng = random.Random(11)
    recs_a = j_random_records(
        rng, chrom="chr5", n=700, n_samples=4, spacing=12,
        p_symbolic=0.12, p_multiallelic=0.3,
    )
    recs_b = j_random_records(rng, chrom="5", n=400, n_samples=3, spacing=20)
    recs_c = j_random_records(rng, chrom="5", n=300, n_samples=0, spacing=6)
    recs_c += j_random_records(rng, chrom="22", n=200, n_samples=0)
    return [
        ("dsA", "a.vcf.gz", recs_a, ["a0", "a1", "a2", "a3"]),
        ("dsB", "b.vcf.gz", recs_b, ["b0", "b1", "b2"]),
        ("dsC", "c.vcf.gz", recs_c, []),
    ]


@pytest.fixture(scope="module")
def shards():
    out = []
    for ds, vcf, recs, names in _records():
        out.append(
            j_build_index(
                recs, dataset_id=ds, vcf_location=vcf, sample_names=names
            )
        )
    return out


_ENGINES: dict = {}


def _engines(shards, window_cap, record_cap, microbatch):
    key = (window_cap, record_cap, microbatch)
    if key not in _ENGINES:
        jeng = JVariantEngine(
            JBeaconConfig(
                engine=JEngineConfig(
                    use_mesh=False, response_cache=False,
                    window_cap=window_cap, record_cap=record_cap,
                    microbatch=microbatch,
                )
            )
        )
        teng = VariantEngine(
            BeaconConfig(
                engine=EngineConfig(
                    window_cap=window_cap, record_cap=record_cap,
                    microbatch=microbatch,
                )
            ),
            device="cpu",
        )
        for s in shards:
            jeng.add_index(s)
            teng.add_index(shard_from_reference(s))
        _ENGINES[key] = (jeng, teng)
    return _ENGINES[key]


@pytest.fixture(scope="module", autouse=True)
def _close_engines():
    yield
    for jeng, teng in _ENGINES.values():
        jeng.close()
        teng.close()
    _ENGINES.clear()


def _payloads(shards, seed, n):
    """Every query kind: exact SNV points that hit, any-base and type
    queries, length bounds, brackets of every width (wide ones overflow
    to the host), one and several datasets, every granularity."""
    rng = random.Random(seed)
    base = shards[0]
    pos = base.cols["pos"]
    out = []
    for _ in range(n):
        i = rng.randrange(len(pos))
        p = int(pos[i])
        kind = rng.randrange(6)
        kw = {}
        if kind == 0:
            kw = dict(
                start_min=p, start_max=p, end_min=p,
                end_max=p + len(base.row_ref(i)) + 5,
                reference_bases=base.row_ref(i),
                alternate_bases=base.row_alt(i),
            )
        else:
            w = rng.choice([0, 30, 300, 3000, 30000])
            kw = dict(
                start_min=max(1, p - w), start_max=p + w, end_min=0,
                end_max=10**9,
                reference_bases=rng.choice([None, "N", "A", "C"]),
            )
            if kind == 1:
                kw["alternate_bases"] = "N"
            elif kind == 2:
                kw["variant_type"] = rng.choice(
                    ["DEL", "INS", "DUP", "DUP:TANDEM", "CNV", "SNP", None]
                )
            elif kind == 3:
                kw["alternate_bases"] = rng.choice("ACGT")
            elif kind == 4:
                kw["alternate_bases"] = "N"
                kw["variant_min_length"] = rng.randint(0, 2)
                kw["variant_max_length"] = rng.choice([-1, 1, 4])
            else:
                kw["alternate_bases"] = rng.choice(["N", "AT", "<DEL>"])
        out.append(
            dict(
                dataset_ids=rng.choice([[], ["dsA"], ["dsB", "dsC"], ["dsC"]]),
                reference_name="5",
                requested_granularity=rng.choice(
                    ["boolean", "count", "record", "aggregated"]
                ),
                include_datasets=rng.choice(["NONE", "HIT", "ALL", "MISS"]),
                include_samples=rng.random() < 0.5,
                **kw,
            )
        )
    return out


def _asdicts(responses):
    return [dataclasses.asdict(r) for r in responses]


@pytest.mark.parametrize(
    "window_cap,record_cap,microbatch",
    [(2048, 1024, True), (2048, 1024, False), (256, 32, True), (256, 32, False)],
)
def test_search_matches_jax_engine(shards, window_cap, record_cap, microbatch):
    jeng, teng = _engines(shards, window_cap, record_cap, microbatch)
    for doc in _payloads(shards, seed=window_cap + record_cap, n=60):
        want = jeng.search(JPayload(**doc))
        got = teng.search(VariantQueryPayload(**doc))
        assert _asdicts(got) == _asdicts(want), doc
    if window_cap == 256:
        assert teng.host_fallbacks > 0  # the overflow leg was exercised


def test_search_selected_samples(shards):
    jeng, teng = _engines(shards, 2048, 1024, True)
    rng = random.Random(5)
    pos = shards[0].cols["pos"]
    for _ in range(25):
        p = int(pos[rng.randrange(len(pos))])
        doc = dict(
            dataset_ids=["dsA", "dsB"],
            reference_name="5",
            reference_bases=rng.choice(["N", "A", "AN", None]),
            alternate_bases=rng.choice(["N", None, "G"]),
            start_min=max(1, p - 400), start_max=p + 400,
            end_min=0, end_max=10**9,
            requested_granularity=rng.choice(["count", "record"]),
            include_datasets="HIT",
            include_samples=True,
            sample_names={"dsA": ["a1", "a3"], "dsB": ["b0"]},
            selected_samples_only=True,
        )
        want = jeng.search(JPayload(**doc))
        got = teng.search(VariantQueryPayload(**doc))
        assert _asdicts(got) == _asdicts(want), doc


def test_concurrent_searches_coalesce(shards):
    """Threads submitting together share launches (the micro-batcher
    holds each leader 200 ms) and still get the JAX engine's answers.
    With the planes on the device, requests that read them take the
    fused match + planes kernel, one launch each outside the batcher, as
    in the JAX engine; with host planes every request is batched."""
    jeng, _ = _engines(shards, 2048, 1024, False)
    for device_planes in (True, False):
        _coalesce(shards, jeng, device_planes)


def _coalesce(shards, jeng, device_planes):
    teng = VariantEngine(
        BeaconConfig(engine=EngineConfig(microbatch_wait_ms=200.0,
                                         device_planes=device_planes)),
        device="cpu",
    )
    try:
        for s in shards:
            teng.add_index(shard_from_reference(s))
        docs = _payloads(shards, seed=3, n=24)
        for d in docs:
            d["dataset_ids"] = ["dsA"]
        got = [None] * len(docs)
        barrier = threading.Barrier(len(docs))

        def run(k):
            barrier.wait(timeout=30)
            got[k] = teng.search(VariantQueryPayload(**docs[k]))

        threads = [threading.Thread(target=run, args=(k,)) for k in range(len(docs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        occ = teng.batcher.occupancy()
        batched = [
            d for d in docs
            if not (device_planes
                    and VariantEngine._wants_planes(VariantQueryPayload(**d)))
        ]
        assert occ["submits"] == len(batched) >= len(docs) // 2
        assert occ["launches"] < occ["submits"]
        for d, g in zip(docs, got):
            assert _asdicts(g) == _asdicts(jeng.search(JPayload(**d)))
    finally:
        teng.close()


def _bodies():
    rng = random.Random(9)
    out = []
    for k in range(24):
        start = rng.randint(1000, 9000)
        gran = ["boolean", "count", "record", "aggregated"][k % 4]
        rp = {
            "assemblyId": "GRCh38",
            "referenceName": rng.choice(["5", "chr5", "22"]),
            "start": [start] if k % 3 else [start, start + 500],
            "end": [start + 2000] if k % 3 else [start, start + 4000],
        }
        pick = k % 5
        if pick == 0:
            rp.update(referenceBases="n", alternateBases="N")
        elif pick == 1:
            rp.update(alternateBases=rng.choice("acgt"))
        elif pick == 2:
            rp.update(variantType=rng.choice(["del", "DUP", "CNV"]))
        elif pick == 3:
            rp.update(alternateBases="N", variantMinLength=1,
                      variantMaxLength=3)
        query = {
            "requestedGranularity": gran,
            "includeResultsetResponses": rng.choice(["HIT", "ALL", "NONE"]),
            "requestParameters": rp,
        }
        if k % 4 == 2:
            query["pagination"] = {"skip": k % 3, "limit": 5}
        out.append({"meta": {"apiVersion": "2.0"}, "query": query})
    return out


@pytest.mark.parametrize("microbatch", [True, False])
def test_variant_search_envelopes_byte_identical(shards, microbatch):
    jeng, teng = _engines(shards, 2048, 1024, microbatch)
    datasets = [{"id": "dsA"}, {"id": "dsB"}, {"id": "dsC"}]
    jenv = JEnvelopes(JBeaconInfo())
    tenv = Envelopes(BeaconInfo())
    for body in _bodies():
        outs = []
        for parse, run, eng, env in (
            (j_parse_request, j_run_variant_search, jeng, jenv),
            (parse_request, run_variant_search, teng, tenv),
        ):
            req = parse("POST", None, body)
            s_min, s_max, e_min, e_max = req.coordinates()
            agg = run(
                eng, datasets, req, start_min=s_min, start_max=s_max,
                end_min=e_min, end_max=e_max,
            )
            outs.append(
                json.dumps(
                    env.by_granularity(
                        req.granularity,
                        exists=agg.exists,
                        count=len(agg.variants),
                        results=agg.results[req.skip : req.skip + req.limit],
                        set_type="genomicVariant",
                        skip=req.skip,
                        limit=req.limit,
                    ),
                    sort_keys=True,
                )
            )
        assert outs[0] == outs[1], body


_BAD_BODIES = [
    [1],
    "x",
    {"query": []},
    {"query": {"requestedGranularity": "foo"}},
    {"query": {"includeResultsetResponses": "SOME"}},
    {"query": {"pagination": {"skip": -1, "limit": "a"}}},
    {"query": {"pagination": {"limit": True}}},
    {"query": {"filters": [5, {"x": 1}, {"id": 3}, "ok"]}},
    {"query": {"filters": "nope"}},
    {"query": {"requestParameters": {"start": [1, 2, 3]}}},
    {"query": {"requestParameters": {"start": ["a", -1], "end": [2.5]}}},
    {"query": {"requestParameters": {"referenceBases": "XYZ"}}},
    {"query": {"requestParameters": {"alternateBases": 7}}},
    {"query": {"requestParameters": {"variantMinLength": -3}}},
    {"query": {"requestParameters": {"referenceName": 5, "assemblyId": []}}},
    {"meta": 1, "query": {"requestedGranularity": 2}},
    {"query": {"requestParameters": {"start": [1.0], "end": [4]}}},
]


@pytest.mark.parametrize("body", _BAD_BODIES, ids=range(len(_BAD_BODIES)))
def test_request_validation_matches_jsonschema(body):
    """The port's own schema checker raises where jsonschema does, with
    the same message (location included)."""
    try:
        want = repr(j_parse_request("POST", None, body))
    except JRequestError as e:
        want = f"RequestError: {e}"
    try:
        got = repr(parse_request("POST", None, body))
    except RequestError as e:
        got = f"RequestError: {e}"
    assert got.replace("sbeacon_tpu_torch", "sbeacon_tpu") == want


def test_get_requests_parse_alike():
    params = {
        "start": "100,200", "end": "300,400", "referenceName": "chr5",
        "alternateBases": "a", "requestedGranularity": "count",
        "filters": "A,B", "skip": "2",
    }
    want = j_parse_request("GET", params, None)
    got = parse_request("GET", params, None)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.coordinates() == want.coordinates()


def test_build_index_matches():
    """The port's index builder gives the JAX builder's shard."""
    for ds, vcf, recs, names in _records():
        want = j_build_index(recs, dataset_id=ds, vcf_location=vcf,
                             sample_names=names)
        got = build_index(recs, dataset_id=ds, vcf_location=vcf,
                          sample_names=names)
        assert got.meta == want.meta
        assert set(got.cols) == set(want.cols)
        for k in want.cols:
            np.testing.assert_array_equal(got.cols[k], want.cols[k], err_msg=k)
        for k in ("chrom_offsets", "ref_blob", "ref_off", "alt_blob",
                  "alt_off", "vt_codes", "gt_bits", "gt_bits2", "tok_bits1",
                  "tok_bits2", "gt_overflow", "tok_overflow"):
            a, b = getattr(got, k), getattr(want, k)
            assert (a is None) == (b is None), k
            if b is not None:
                np.testing.assert_array_equal(a, b, err_msg=k)


def test_synthetic_shard_matches():
    """The port's corpus generator reproduces the JAX package's."""
    from sbeacon_tpu.testing import synthetic_shard as j_synthetic

    want = j_synthetic(20_000, seed=4, chroms=["1", "2", "22"])
    got = t_testing.synthetic_shard(20_000, seed=4, chroms=["1", "2", "22"])
    assert got.meta == want.meta
    for k in want.cols:
        np.testing.assert_array_equal(got.cols[k], want.cols[k], err_msg=k)
    for k in ("chrom_offsets", "ref_blob", "ref_off", "alt_blob", "alt_off"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


def test_records_generator_matches():
    want = j_random_records(random.Random(2), n=200)
    got = t_testing.random_records(random.Random(2), n=200)
    assert [dataclasses.asdict(r) for r in got] == [
        dataclasses.asdict(r) for r in want
    ]
    assert isinstance(want[0], JVcfRecord)
