"""The port's CPU oracle and materialisation spec against the JAX
package's, at tolerance 0.

``oracle.oracle_search`` and ``match_record`` (the spec matcher over
parsed VCF records) equal JAX's on the golden corpus (and its expected
constants) and on seeded records over every query shape, granularity,
detail switch and selected-sample set. ``engine.materialize_response_loop``
equals JAX's loop and the port's vectorised ``materialize_response`` on
the golden shard and on seeded records with ploidy > 2 overflow entries.
The port's engine (on the CPU) answers equal to the port's oracle.
"""

from __future__ import annotations

import dataclasses
import random

import pytest

from sbeacon_tpu.engine import materialize_response_loop as j_loop
from sbeacon_tpu.genomics.vcf import iter_vcf_records as j_iter_records
from sbeacon_tpu.index import build_index as j_build_index
from sbeacon_tpu.oracle import cpu_oracle as joracle
from sbeacon_tpu.payloads import VariantQueryPayload as JPayload
from sbeacon_tpu.testing import random_records
from sbeacon_tpu_torch.config import BeaconConfig, EngineConfig
from sbeacon_tpu_torch.engine import (
    VariantEngine,
    host_match_rows,
    materialize_response,
    materialize_response_loop,
)
from sbeacon_tpu_torch.genomics.bgzf import BgzfWriter
from sbeacon_tpu_torch.genomics.tabix import ensure_index
from sbeacon_tpu_torch.genomics.vcf import VcfRecord, iter_vcf_records
from sbeacon_tpu_torch.index.columnar import shard_from_reference
from sbeacon_tpu_torch.ops.kernel import QuerySpec
from sbeacon_tpu_torch.oracle import cpu_oracle as toracle
from sbeacon_tpu_torch.oracle import match_record, oracle_search
from sbeacon_tpu_torch.payloads import VariantQueryPayload
from test_golden_corpus import EXPECTED, GOLDEN, S
from torch_ingest_corpus import no_thread_leak  # noqa: F401


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The golden corpus through the port's BGZF writer and tabix
    index: (port records, JAX records) of the same file."""
    vcf_gz = tmp_path_factory.mktemp("golden") / "golden.vcf.gz"
    w = BgzfWriter(vcf_gz)
    w.write(GOLDEN.read_bytes())
    w.close()
    ensure_index(vcf_gz)
    recs = list(iter_vcf_records(vcf_gz))
    jrecs = list(j_iter_records(vcf_gz))
    assert len(recs) == len(jrecs) == 50
    return recs, jrecs, vcf_gz


def _port_record(jrec) -> VcfRecord:
    return VcfRecord(**dataclasses.asdict(jrec))


def _both(recs, jrecs, **kw):
    """(port answer, JAX answer) of one oracle search, as dicts."""
    got = oracle_search(recs, **kw)
    want = joracle.oracle_search(jrecs, **kw)
    return dataclasses.asdict(got), dataclasses.asdict(want)


def test_oracle_matches_golden(golden):
    """The port's oracle is held to the golden constants, and equals
    JAX's on every case at every granularity and detail switch."""
    recs, jrecs, _ = golden
    checked = 0
    for case, (q, want) in enumerate(EXPECTED):
        if "selected" in q:
            continue
        on = [r for r in recs if r.chrom == q["reference_name"]]
        jon = [r for r in jrecs if r.chrom == q["reference_name"]]
        base = dict(first_bp=q["start_min"], last_bp=q["start_max"],
                    end_min=q.get("end_min", 1),
                    end_max=q.get("end_max", 2**30),
                    reference_bases=q.get("reference_bases"),
                    alternate_bases=q.get("alternate_bases"),
                    variant_type=q.get("variant_type"))
        res = oracle_search(on, requested_granularity="record",
                            include_details=True, **base)
        assert res.exists == want["exists"], case
        assert res.call_count == want["call_count"], case
        assert res.all_alleles_count == want["all_alleles_count"], case
        for gran in ("boolean", "count", "record", "aggregated"):
            for details in (True, False):
                got, jwant = _both(
                    on, jon, requested_granularity=gran,
                    include_details=details, include_samples=True,
                    sample_names=S, dataset_id="golden",
                    chrom_label=q["reference_name"], **base)
                assert got == jwant, (case, gran, details)
                checked += 1
    assert checked > 100


def _specs(rng, recs, chrom, n):
    """Seeded query shapes: points, brackets, typed and length-bounded
    windows over the records' positions."""
    pos = [r.pos for r in recs]
    out = []
    for _ in range(n):
        p = rng.choice(pos)
        lo = max(1, p - rng.randint(0, 400))
        out.append(dict(
            first_bp=lo, last_bp=p + rng.randint(0, 400),
            end_min=rng.choice([1, lo]),
            end_max=rng.choice([1 << 30, p + 600]),
            reference_bases=rng.choice([None, "N", "A"]),
            alternate_bases=rng.choice([None, "N", "T", "A", "<DEL>"]),
            variant_type=rng.choice([None, None, "DEL", "CNV", "DUP",
                                     "SNP", "INS"]),
            variant_min_length=rng.choice([0, 0, 1, 2]),
            variant_max_length=rng.choice([-1, -1, 3, 50])))
    return out


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_oracle_matches_jax_on_seeded_records(seed):
    rng = random.Random(seed)
    jrecs = random_records(rng, chrom="7", n=300, n_samples=5,
                           p_symbolic=0.15, p_multiallelic=0.3,
                           p_no_acan=0.4)
    recs = [_port_record(r) for r in jrecs]
    names = [f"S{i}" for i in range(5)]
    for k, spec in enumerate(_specs(rng, jrecs, "7", 40)):
        sel = rng.choice([None, [0, 2], [4], []])
        for gran in ("boolean", "count", "record"):
            got, want = _both(
                recs, jrecs, requested_granularity=gran,
                include_details=rng.random() < 0.8,
                include_samples=True, sample_names=names, dataset_id="sd",
                chrom_label="7", selected_sample_idx=sel, **spec)
            assert got == want, (seed, k, gran)
    # the per-record matcher too
    spec = dict(first_bp=1, last_bp=1 << 30, end_min=1, end_max=1 << 30,
                reference_bases=None, alternate_bases="N", variant_type=None)
    hits = 0
    for rec, jrec in zip(recs, jrecs):
        got, want = match_record(rec, **spec), joracle.match_record(jrec,
                                                                    **spec)
        assert (got is None) == (want is None)
        if got is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            hits += 1
    assert hits > 0


def _overflow_records(seed):
    rng = random.Random(seed)
    recs = random_records(rng, chrom="11", n=300, n_samples=9,
                          p_multiallelic=0.35, p_symbolic=0.1,
                          p_no_acan=0.5)
    # ploidy > 2 genotypes, so the overflow side tables are non-empty
    for rec in recs[::7]:
        rec.genotypes[rng.randrange(9)] = "1|1|1"
        rec.ac = None
        rec.an = None
    return rng, recs


def test_materialize_loop_matches_jax_and_vectorised():
    """The port's loop spec equals JAX's loop and the port's vectorised
    ``materialize_response`` on every (granularity, details, selected
    samples) branch over seeded matched-row sets."""
    rng, recs = _overflow_records(97)
    names = [f"S{i}" for i in range(9)]
    jshard = j_build_index(recs, dataset_id="vm", sample_names=names)
    shard = shard_from_reference(jshard)
    pos = shard.cols["pos"]
    cases = 0
    for trial in range(25):
        p = int(pos[rng.randrange(len(pos))])
        spec = QuerySpec("11", max(1, p - rng.randint(0, 300)),
                         p + rng.randint(0, 300), 1, 1 << 30,
                         alternate_bases=rng.choice(["N", None, "T"]),
                         variant_type=rng.choice([None, "DEL", "CNV"]))
        rows = host_match_rows(shard, spec)
        for gran in ("boolean", "count", "record", "aggregated"):
            for details in (True, False):
                for sel in (None, [0, 3, 8], []):
                    doc = dict(
                        dataset_ids=["vm"], reference_name="11",
                        start_min=spec.start_min, start_max=spec.start_max,
                        end_min=1, end_max=1 << 30,
                        requested_granularity=gran,
                        include_datasets="HIT" if details else "NONE",
                        include_samples=True,
                        selected_samples_only=sel is not None)
                    kw = dict(chrom_label="11", dataset_id="vm",
                              selected_idx=sel)
                    got = materialize_response_loop(
                        shard, rows, VariantQueryPayload(**doc), **kw)
                    assert dataclasses.asdict(got) == dataclasses.asdict(
                        j_loop(jshard, rows, JPayload(**doc), **kw))
                    assert materialize_response(
                        shard, rows, VariantQueryPayload(**doc), **kw) == got
                    cases += 1
    assert cases == 25 * 4 * 2 * 3


def test_materialize_loop_matches_on_golden(golden):
    """The loop spec over the golden shard's matched rows: the port's
    equals JAX's and the port's vectorised form, every expected case."""
    _recs, jrecs, vcf_gz = golden
    jshard = j_build_index(jrecs, dataset_id="golden",
                           vcf_location=str(vcf_gz), sample_names=S)
    shard = shard_from_reference(jshard)
    for case, (q, _want) in enumerate(EXPECTED):
        spec = QuerySpec(q["reference_name"], q["start_min"], q["start_max"],
                         q.get("end_min", 1), q.get("end_max", 2**30),
                         reference_bases=q.get("reference_bases"),
                         alternate_bases=q.get("alternate_bases"),
                         variant_type=q.get("variant_type"))
        rows = host_match_rows(shard, spec)
        sel = ([S.index(s) for s in q["selected"]] if "selected" in q
               else None)
        for gran in ("count", "record"):
            doc = dict(dataset_ids=["golden"],
                       reference_name=q["reference_name"],
                       start_min=q["start_min"], start_max=q["start_max"],
                       requested_granularity=gran, include_samples=True,
                       selected_samples_only=sel is not None)
            kw = dict(chrom_label=q["reference_name"], dataset_id="golden",
                      selected_idx=sel)
            got = materialize_response_loop(
                shard, rows, VariantQueryPayload(**doc), **kw)
            assert dataclasses.asdict(got) == dataclasses.asdict(
                j_loop(jshard, rows, JPayload(**doc), **kw)), case
            assert materialize_response(
                shard, rows, VariantQueryPayload(**doc), **kw) == got, case


def test_engine_matches_port_oracle():
    """The port's engine on the CPU (the kernels' twins) answers equal
    to the port's oracle over the same records: exists, counts and the
    variant strings, at record granularity."""
    rng = random.Random(5)
    jrecs = random_records(rng, chrom="3", n=400, n_samples=4,
                           p_symbolic=0.1, p_multiallelic=0.25)
    recs = [_port_record(r) for r in jrecs]
    eng = VariantEngine(BeaconConfig(engine=EngineConfig(
        microbatch=False, response_cache=False)), device="cpu")
    try:
        eng.add_index(shard_from_reference(j_build_index(
            jrecs, dataset_id="eo", sample_names=[f"S{i}" for i in
                                                   range(4)])))
        for k, spec in enumerate(_specs(rng, jrecs, "3", 30)):
            spec["reference_bases"] = spec["reference_bases"] or "N"
            gran, inc = rng.choice([("record", "HIT"), ("record", "NONE"),
                                    ("count", "HIT"), ("boolean", "HIT")])
            payload = VariantQueryPayload(
                dataset_ids=["eo"], reference_name="3",
                start_min=spec["first_bp"], start_max=spec["last_bp"],
                end_min=spec["end_min"], end_max=spec["end_max"],
                reference_bases=spec["reference_bases"],
                alternate_bases=spec["alternate_bases"],
                variant_type=spec["variant_type"],
                variant_min_length=spec["variant_min_length"],
                variant_max_length=spec["variant_max_length"],
                requested_granularity=gran, include_datasets=inc)
            (got,) = eng.search(payload)
            want = oracle_search(
                recs, requested_granularity=gran,
                include_details=payload.include_details,
                include_samples=payload.include_samples, dataset_id="eo",
                vcf_location=got.vcf_location, chrom_label="3", **spec)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), k
    finally:
        eng.close()


def test_oracle_module_is_the_jax_modules_copy():
    """The spec's helpers and constants are JAX's."""
    assert toracle.BASES == joracle.BASES
    assert [f.name for f in dataclasses.fields(toracle.MatchResult)] == [
        f.name for f in dataclasses.fields(joracle.MatchResult)]
