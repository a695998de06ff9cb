"""The port's fused match + planes kernel and device-plane serving held
against the JAX package.

The same seeded corpora (40 samples: two plane words with a tail word;
ploidy > 2 "1|1|1|1" genotypes; genotype-derived and INFO-sourced
counts; 12-alt records for the scan form) and queries go through the JAX
package (``_selected_batch``, ``run_selected_scattered``,
``materialize_response_loop``, ``VariantEngine`` with ``device_planes``
on; XLA on the CPU) and the port on ``device="cpu"``, where each kernel
wrapper runs its plain-PyTorch twin. Every output is an integer: the
tolerance is 0. The one documented difference: the pad lanes
(``rows == -1``) of ``pc_call``/``pc_tok`` are 0 in the port, so those
compare only where ``rows >= 0``. The CUDA kernel itself is held against
the twin on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import random
from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbeacon_tpu.config import BeaconConfig as JBeaconConfig
from sbeacon_tpu.config import EngineConfig as JEngineConfig
from sbeacon_tpu.engine import VariantEngine as JVariantEngine
from sbeacon_tpu.engine import materialize_response_loop
from sbeacon_tpu.genomics.vcf import VcfRecord
from sbeacon_tpu.index import build_index as j_build_index
from sbeacon_tpu.ops import plane_kernel as jpk
from sbeacon_tpu.ops import scatter_kernel as jsk
from sbeacon_tpu.ops.kernel import QuerySpec, encode_queries
from sbeacon_tpu.ops.query_pack import _window_bounds, pack_q8
from sbeacon_tpu.payloads import VariantQueryPayload as JPayload
from sbeacon_tpu.testing import random_records as j_random_records
from sbeacon_tpu_torch.config import BeaconConfig, EngineConfig
from sbeacon_tpu_torch.engine import (
    VariantEngine,
    host_match_rows,
    materialize_response,
)
from sbeacon_tpu_torch.index import shard_from_reference
from sbeacon_tpu_torch.ops import plane_kernel as tpk
from sbeacon_tpu_torch.ops import scatter_kernel as tsk
from sbeacon_tpu_torch.payloads import VariantQueryPayload
from torch_ingest_corpus import no_thread_leak  # noqa: F401

N_SAMPLES = 40
NAMES = [f"S{i}" for i in range(N_SAMPLES)]


def _records(seed, *, p_no_acan=0.5, long_records=False, n=400,
             chrom="7", overflow_every=7):
    rng = random.Random(seed)
    recs = j_random_records(
        rng, chrom=chrom, n=n, n_samples=N_SAMPLES, p_multiallelic=0.3,
        p_symbolic=0.08, p_no_acan=p_no_acan,
    )
    # ploidy > 2 saturation rows: the 2-bit planes clip, the exact values
    # ride the host side tables (extras host-added on top of device pc)
    for rec in recs[::overflow_every]:
        rec.genotypes[rng.randrange(N_SAMPLES)] = "1|1|1|1"
        rec.ac = None
        rec.an = None
    if long_records:
        # 12-alt records: longer than the K-shift regime (scan form)
        last = recs[-1].pos
        for i in range(20):
            gts = [f"{rng.randint(0, 12)}/{rng.randint(0, 12)}"
                   for _ in range(N_SAMPLES)]
            recs.append(VcfRecord(
                chrom=chrom, pos=last + 10 + 7 * i, ref="AC",
                alts=[b * k for k in (1, 2, 3) for b in "ACGT"], vt="N/A",
                ac=None if i % 2 else [(i + j) % 4 for j in range(12)],
                an=None if i % 2 else 80, genotypes=gts,
            ))
    return recs


def _shard(seed, **kw):
    return j_build_index(_records(seed, **kw), dataset_id="fz",
                         vcf_location="v", sample_names=NAMES)


@pytest.fixture(scope="module")
def corpus():
    return _shard(3, long_records=True)


def _specs(shard, seed, n=60, chrom="7"):
    rng = random.Random(seed)
    pos = shard.cols["pos"]
    out = []
    for _ in range(n):
        i = rng.randrange(len(pos))
        p = int(pos[i])
        kind = rng.randrange(4)
        if kind == 0:
            out.append(QuerySpec(
                chrom, p, p, 1, 1 << 30,
                reference_bases=rng.choice([None, shard.row_ref(i)]),
                alternate_bases=shard.row_alt(i),
            ))
        else:
            out.append(QuerySpec(
                chrom, max(1, p - rng.randint(0, 250)), p + rng.randint(0, 250),
                1, 1 << 30, alternate_bases=rng.choice(["N", None, "T"]),
                variant_type=rng.choice([None, "DEL", "CNV"]),
            ))
    # edge shapes: an empty window, a whole-chromosome span
    out.append(QuerySpec(chrom, 1, 2, 1, 1 << 30))
    out.append(QuerySpec(chrom, 1, 1 << 30, 1, 1 << 30, alternate_bases="N"))
    return out


def _masks(n, W, seed):
    """Per-query masks: all ones, sparse, empty, and random in turn."""
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 2**32, (n, W), dtype=np.uint32)
    m &= rng.integers(0, 2**32, (n, W), dtype=np.uint32)  # sparse
    m[0::4] = 0xFFFFFFFF
    m[1::4] = 0
    m[2::4] = rng.integers(0, 2**32, (len(m[2::4]), W), dtype=np.uint32)
    return m


@pytest.mark.parametrize("with_counts", [True, False])
@pytest.mark.parametrize("form", ["shift", "scan"])
@pytest.mark.parametrize("exact_only", [True, False])
@pytest.mark.parametrize("C", [1, 2, 5, 17])
def test_twin_matches_selected_batch(corpus, C, exact_only, form,
                                     with_counts):
    """Raw (tiles, planes, tile_ids, q8, mask) through JAX
    ``_selected_batch`` and the twin, for every tier width, both exact
    specialisations, both first-match forms and both count modes."""
    T = 128
    cap = T if C == 1 else (C - 1) * T
    R = min(64 if C < 17 else 1024, cap)
    jindex = jsk.ScatterDeviceIndex(corpus, tile=T)
    jp = jpk.PlaneDeviceIndex(corpus)
    specs = _specs(corpus, seed=100 + C, n=61)
    if exact_only:
        specs = [s for s in specs if s.alternate_bases not in (None, "N")]
        specs = [QuerySpec(s.chrom, s.start_min, s.start_max, 1, 1 << 30,
                           reference_bases=s.reference_bases,
                           alternate_bases=s.alternate_bases or "T")
                 for s in specs]
    enc = encode_queries(specs)
    lo, hi = _window_bounds(jindex, enc)
    q8, _ = pack_q8(enc, lo, hi)
    tile_ids = (lo // T).astype(np.int32)
    mask = _masks(len(specs), jp.n_words, C)
    seg_k = jindex.seg_k if form == "shift" else None
    want = jsk._selected_batch(
        jindex.tiles, jp.gt, jp.gt2, jp.tok1, jp.tok2, jnp.asarray(tile_ids),
        jnp.asarray(q8), jnp.asarray(mask.view(np.int32)), T=T, CAP=cap,
        nslots=len(specs), C=C, exact_only=exact_only, R=R,
        with_counts=with_counts, seg_k=seg_k,
    )
    t = lambda a: torch.from_numpy(np.array(a))
    got = tsk.scatter_selected_reference(
        t(jindex.tiles), t(jp.gt), t(jp.gt2), t(jp.tok1), t(jp.tok2),
        torch.from_numpy(tile_ids), torch.from_numpy(q8),
        torch.from_numpy(mask.view(np.int32)), T=T, CAP=cap, C=C,
        exact_only=exact_only, R=R, with_counts=with_counts, seg_k=seg_k,
    )
    agg, rows, pc_call, pc_tok, or_words = (np.asarray(x) for x in want)
    assert all(x.dtype == torch.int32 for x in got)
    np.testing.assert_array_equal(got[0].numpy(), agg)
    np.testing.assert_array_equal(got[1].numpy(), rows)
    keep = rows >= 0
    np.testing.assert_array_equal(got[2].numpy()[keep], pc_call[keep])
    np.testing.assert_array_equal(got[3].numpy()[keep], pc_tok[keep])
    assert not got[2].numpy()[~keep].any() and not got[3].numpy()[~keep].any()
    np.testing.assert_array_equal(got[4].numpy(), or_words)
    assert keep.sum() > 0 and (or_words != 0).any()


def _run_both(shard, specs, masks, **kw):
    jindex = jsk.ScatterDeviceIndex(shard)
    jp = jpk.PlaneDeviceIndex(shard)
    tshard = shard_from_reference(shard)
    tindex = tsk.ScatterDeviceIndex(tshard, "cpu")
    tp = tpk.PlaneDeviceIndex(tshard, "cpu")
    want = jsk.run_selected_scattered(jindex, jp, specs, masks, **kw)
    got = tsk.run_selected_scattered(tindex, tp, specs, masks, **kw)
    return got, want


def _assert_selected_equal(got, want):
    for f in ("exists", "call_count", "n_variants", "all_alleles_count",
              "n_matched", "overflow", "rows", "or_words"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    keep = want.rows >= 0
    for f in ("pc_call", "pc_tok"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a[keep], b[keep], err_msg=f)
        assert not a[~keep].any(), f


@pytest.mark.parametrize(
    "window_cap,record_cap,with_counts",
    [(512, 64, None), (2048, 1024, True), (2048, 1024, False), (256, 16, None)],
)
def test_run_selected_scattered_matches_jax(corpus, window_cap, record_cap,
                                            with_counts):
    specs = _specs(corpus, seed=window_cap + record_cap, n=80)
    masks = _masks(len(specs), 2, seed=record_cap)
    got, want = _run_both(corpus, specs, masks, window_cap=window_cap,
                          record_cap=record_cap, with_counts=with_counts)
    _assert_selected_equal(got, want)
    assert (~got.overflow).sum() > 20
    if record_cap == 16:
        assert got.overflow.any()


def test_run_selected_scattered_empty_batch(corpus):
    got, want = _run_both(corpus, [], np.zeros((0, 2), np.uint32))
    _assert_selected_equal(got, want)
    assert got.rows.shape == (0, 0)


@pytest.mark.parametrize("seed,p_no_acan", [(5, 0.6), (7, 0.0), (13, 0.3)])
def test_fused_materialisation_matches_loop_spec(seed, p_no_acan):
    """``materialize_response(fused=...)`` from the port's
    ``run_selected_scattered`` equals the JAX loop spec across
    granularities, details and selections (the sweep of
    tests/test_fused_selected.py)."""
    shard = _shard(seed, p_no_acan=p_no_acan)
    tshard = shard_from_reference(shard)
    tindex = tsk.ScatterDeviceIndex(tshard, "cpu")
    tp = tpk.PlaneDeviceIndex(tshard, "cpu")
    cases = 0
    for spec in _specs(shard, seed + 2, n=25):
        for sel in (None, [0, 3, 8, 33, 39], []):
            mask = (
                tpk.sample_mask_words(sel, tp.n_words)
                if sel is not None
                else np.full(tp.n_words, 0xFFFFFFFF, np.uint32)
            )
            res = tsk.run_selected_scattered(
                tindex, tp, [spec], mask[None, :], window_cap=512,
                record_cap=64, with_counts=sel is not None and tp.has_counts,
            )
            if res.overflow[0]:
                continue
            keep = res.rows[0] >= 0
            rows = res.rows[0][keep].astype(np.int64)
            fused = (res.pc_call[0][keep], res.pc_tok[0][keep],
                     res.or_words[0])
            if not np.array_equal(
                rows, host_match_rows(tshard, spec, ref_wildcard=sel is not None)
            ):
                continue  # wildcard-ref divergence is host-only by contract
            for gran in ("boolean", "count", "record"):
                for details in (True, False):
                    doc = dict(
                        dataset_ids=["fz"], reference_name="7",
                        start_min=spec.start_min, start_max=spec.start_max,
                        end_min=1, end_max=1 << 30,
                        requested_granularity=gran,
                        include_datasets="HIT" if details else "NONE",
                        include_samples=True,
                        selected_samples_only=sel is not None,
                    )
                    kw = dict(chrom_label="7", dataset_id="fz",
                              selected_idx=sel)
                    want = materialize_response_loop(
                        shard, rows, JPayload(**doc), **kw
                    )
                    got = materialize_response(
                        tshard, rows, VariantQueryPayload(**doc),
                        fused=fused, **kw
                    )
                    assert asdict(got) == asdict(want), (spec, doc, sel)
                    cases += 1
    assert cases > 50


def _engine_shards():
    """Two datasets with planes (genotype-derived counts, 40 samples)
    and one without samples, on chromosome 7."""
    a = _records(21, p_no_acan=0.5, long_records=True)
    b = _records(22, p_no_acan=0.0, n=300)
    c = j_random_records(random.Random(23), chrom="7", n=300, n_samples=0,
                         spacing=8)
    return [
        j_build_index(r, dataset_id=d, vcf_location=f"{d}.vcf.gz",
                      sample_names=names)
        for r, d, names in ((a, "dsA", NAMES), (b, "dsB", NAMES), (c, "dsC", []))
    ]


_ENGINES: dict = {}


def _engines(window_cap, record_cap):
    key = (window_cap, record_cap)
    if key not in _ENGINES:
        shards = _engine_shards()
        jeng = JVariantEngine(JBeaconConfig(engine=JEngineConfig(
            use_mesh=False, response_cache=False, device_planes=True,
            window_cap=window_cap, record_cap=record_cap,
        )))
        teng = VariantEngine(BeaconConfig(engine=EngineConfig(
            device_planes=True, window_cap=window_cap, record_cap=record_cap,
        )), device="cpu")
        for s in shards:
            jeng.add_index(s)
            teng.add_index(shard_from_reference(s))
        _ENGINES[key] = (jeng, teng, shards)
    return _ENGINES[key]


@pytest.fixture(scope="module", autouse=True)
def _close_engines():
    yield
    for jeng, teng, _s in _ENGINES.values():
        jeng.close()
        teng.close()
    _ENGINES.clear()


def _docs(shards, seed, n):
    """Selected samples (fixed and N-wildcard refs), sample extraction
    on record/aggregated granularity, brackets wide enough to overflow,
    one and several datasets."""
    rng = random.Random(seed)
    pos = shards[0].cols["pos"]
    out = []
    for k in range(n):
        i = rng.randrange(len(pos))
        p = int(pos[i])
        w = rng.choice([0, 50, 300, 3000, 30000])
        ds = rng.choice([["dsA"], ["dsB"], ["dsA", "dsB"], [], ["dsA", "dsC"]])
        doc = dict(
            dataset_ids=ds, reference_name="7", start_min=max(1, p - w),
            start_max=p + w, end_min=0, end_max=10**9,
            reference_bases=rng.choice(
                [None, "N", shards[0].row_ref(i), "AN", "NA"]),
            alternate_bases=rng.choice(["N", None, "G", shards[0].row_alt(i)]),
            requested_granularity=rng.choice(
                ["boolean", "count", "record", "aggregated"]),
            include_datasets=rng.choice(["HIT", "ALL", "NONE"]),
            include_samples=True,
        )
        if k % 2:
            named = ds or ["dsA", "dsB", "dsC"]
            doc["sample_names"] = {
                d: rng.sample(NAMES, rng.randint(1, 12)) for d in named
            }
            doc["selected_samples_only"] = True
        out.append(doc)
    return out


@pytest.mark.parametrize("window_cap,record_cap", [(2048, 1024), (256, 16)])
def test_engine_device_planes_match_jax(window_cap, record_cap):
    """``VariantEngine.search`` with ``device_planes`` on, against the
    JAX engine with ``device_planes`` on (which serves the split path
    through its XLA index on the CPU): selected samples, sample
    extraction, N-wildcard refs, overflow and several datasets."""
    jeng, teng, _shards = _engines(window_cap, record_cap)
    assert all(
        (p is not None) == (ds != "dsC")
        for ds, _v, (_s, _i, p) in teng.indexes_for([])
    )
    fallbacks0 = teng.host_fallbacks
    for doc in _docs(_shards, seed=window_cap, n=60):
        want = jeng.search(JPayload(**doc))
        got = teng.search(VariantQueryPayload(**doc))
        assert [asdict(r) for r in got] == [asdict(r) for r in want], doc
    if record_cap == 16:
        assert teng.host_fallbacks > fallbacks0  # the split path served


def _counting(monkeypatch):
    """Count calls of the three kernel wrappers as the engine makes
    them (on the CPU the wrappers record no launch)."""
    calls = {"scatter_selected": 0, "plane_stats": 0, "scatter_match": 0}
    for mod, name in ((tsk, "scatter_selected"), (tpk, "plane_stats"),
                      (tsk, "scatter_match")):
        orig = getattr(mod, name)

        def wrapped(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, name, wrapped)
    return calls


def test_one_scatter_selected_launch_per_request(monkeypatch):
    """A plane-reading request on a shard with device planes costs
    exactly one fused kernel call and no other kernel."""
    _jeng, teng, shards = _engines(2048, 1024)
    calls = _counting(monkeypatch)
    pos = shards[0].cols["pos"]
    rng = random.Random(31)
    for k in range(20):
        p = int(pos[rng.randrange(len(pos))])
        doc = dict(
            dataset_ids=["dsA"], reference_name="7", start_min=max(1, p - 150),
            start_max=p + 150, end_min=1, end_max=1 << 30,
            alternate_bases="N", requested_granularity="record",
            include_datasets="HIT", include_samples=True,
            no_response_cache=True,
        )
        if k % 2:
            doc.update(sample_names={"dsA": [NAMES[0], NAMES[4], NAMES[37]]},
                       selected_samples_only=True)
        before = dict(calls)
        teng.search(VariantQueryPayload(**doc))
        assert calls["scatter_selected"] - before["scatter_selected"] == 1
        assert calls["scatter_match"] == before["scatter_match"]
        assert calls["plane_stats"] == before["plane_stats"]


def test_failing_kernel_raises_without_split_fallback(monkeypatch):
    _jeng, teng, shards = _engines(2048, 1024)

    def boom(*a, **kw):
        raise RuntimeError("scatter_selected launch failed: CUDA error 700")

    monkeypatch.setattr(tsk, "scatter_selected", boom)
    p = int(shards[0].cols["pos"][50])
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        teng.search(VariantQueryPayload(
            dataset_ids=["dsA"], reference_name="7", start_min=p - 100,
            start_max=p + 100, end_min=1, end_max=1 << 30,
            alternate_bases="N", requested_granularity="record",
            include_datasets="HIT", include_samples=True,
            sample_names={"dsA": NAMES[:3]}, selected_samples_only=True,
        ))


def test_failing_upload_raises_and_releases(monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("CUDA out of memory")

    monkeypatch.setattr(tpk, "staged_upload", boom)
    eng = VariantEngine(BeaconConfig(engine=EngineConfig(microbatch=False)),
                        device="cpu")
    try:
        with pytest.raises(RuntimeError, match="out of memory"):
            eng.add_index(shard_from_reference(_engine_shards()[0]))
        assert eng._plane_reserved == {} and eng.datasets() == []
    finally:
        eng.close()


def test_engine_polyploid_and_legacy_planes_match_jax():
    """Ploidy > 2 genotypes without INFO AC/AN (the overflow side
    tables add on top of the device popcounts) and a shard holding only
    the gt plane (counts fall back to the baked columns): the port's
    engine with device planes equals the JAX engine's."""
    import dataclasses

    recs = [
        VcfRecord(chrom="3", pos=1000, ref="A", alts=["T"], ac=None,
                  an=None, vt="SNP",
                  genotypes=["1/1/1", "0/1/1", "0/0/0", "1|0"]),
        VcfRecord(chrom="3", pos=1100, ref="C", alts=["G", "T"], ac=None,
                  an=None, vt="SNP",
                  genotypes=["2/2/2/2", "1/2", "0/0", "./."]),
    ]
    poly = j_build_index(recs, dataset_id="poly", vcf_location="p",
                         sample_names=["P0", "P1", "P2", "P3"])
    base = _shard(29, p_no_acan=0.5)
    legacy = dataclasses.replace(
        base, gt_bits2=None, tok_bits1=None, tok_bits2=None,
        gt_overflow=None, tok_overflow=None,
    )
    legacy.meta = dict(base.meta, dataset_id="legacy")
    jeng = JVariantEngine(JBeaconConfig(engine=JEngineConfig(
        use_mesh=False, response_cache=False, microbatch=False)))
    teng = VariantEngine(BeaconConfig(engine=EngineConfig(microbatch=False)),
                         device="cpu")
    try:
        for s in (poly, legacy):
            jeng.add_index(s)
            teng.add_index(shard_from_reference(s))
        planes = {d: p for d, _v, (_s, _i, p) in teng.indexes_for([])}
        assert planes["poly"].has_counts and not planes["legacy"].has_counts
        for ds, chrom, names in (("poly", "3", ["P0", "P1", "P2", "P3"]),
                                 ("legacy", "7", NAMES)):
            for sel in (names[:2], names[1:], names, None):
                doc = dict(
                    dataset_ids=[ds], reference_name=chrom, start_min=1,
                    start_max=500_000, end_min=0, end_max=10**9,
                    alternate_bases="N", requested_granularity="record",
                    include_datasets="ALL", include_samples=True,
                )
                if sel is not None:
                    doc.update(sample_names={ds: sel},
                               selected_samples_only=True)
                want = jeng.search(JPayload(**doc))
                got = teng.search(VariantQueryPayload(**doc))
                assert [asdict(r) for r in got] == [asdict(r) for r in want]
    finally:
        jeng.close()
        teng.close()
