"""The port's scatter match kernel held against the JAX package.

The same seeded corpora and queries go through the JAX program
(``_scatter_batch`` / ``run_queries_scattered``, XLA on the CPU) and the
port (``scatter_core_reference`` / ``run_queries_scattered`` on
``device="cpu"``, where the kernel wrapper runs its plain-PyTorch
twin). Every output is an integer, so the tolerance is 0: equal
``agg``/``masks`` and equal ``QueryResults`` field by field. The CUDA
kernel itself is held against the twin on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbeacon_tpu.genomics.vcf import VcfRecord
from sbeacon_tpu.index import build_index
from sbeacon_tpu.ops import QuerySpec
from sbeacon_tpu.ops import scatter_kernel as jsk
from sbeacon_tpu.ops.kernel import encode_queries
from sbeacon_tpu.ops.query_pack import _window_bounds, pack_q8
from sbeacon_tpu.testing import random_records
from sbeacon_tpu_torch import telemetry
from sbeacon_tpu_torch.index import shard_from_reference
from sbeacon_tpu_torch.ops import scatter_kernel as tsk


def _queries(shard, seed=21, n=40, chroms=("1", "22")):
    """Adversarial mix covering every predicate family (the query mix of
    tests/test_scatter_kernel.py)."""
    rng = random.Random(seed)
    pos = shard.cols["pos"]
    qs = []
    for _ in range(n):
        p = int(pos[rng.randrange(len(pos))])
        chrom = rng.choice(list(chroms))
        lo = max(1, p - rng.randint(0, 400))
        hi = p + rng.randint(0, 400)
        kind = rng.randrange(6)
        if kind == 0:
            qs.append(QuerySpec(chrom, lo, hi, 1, 1 << 30, alternate_bases="N"))
        elif kind == 1:
            qs.append(
                QuerySpec(
                    chrom, lo, hi, 1, 1 << 30,
                    reference_bases=rng.choice("ACGT"),
                    alternate_bases=rng.choice("ACGT"),
                )
            )
        elif kind == 2:
            qs.append(
                QuerySpec(
                    chrom, lo, hi, 1, 1 << 30,
                    variant_type=rng.choice(
                        ["DEL", "INS", "DUP", "DUP:TANDEM", "CNV"]
                    ),
                )
            )
        elif kind == 3:
            qs.append(
                QuerySpec(
                    chrom, lo, hi, lo, hi + 500,
                    variant_min_length=rng.randint(0, 2),
                    variant_max_length=rng.choice([-1, 3]),
                    alternate_bases="N",
                )
            )
        elif kind == 4:
            # exact point query that hits a real row
            i = rng.randrange(len(pos))
            qs.append(
                QuerySpec(
                    shard.row_chrom(i), int(pos[i]), int(pos[i]), 1, 1 << 30,
                    reference_bases=rng.choice(["N", shard.row_ref(i)]),
                    alternate_bases=shard.row_alt(i),
                )
            )
        else:
            qs.append(QuerySpec(chrom, lo, hi, 1, 1 << 30))
    qs.append(QuerySpec("1", 1, 1 << 30, 1, 1 << 30, alternate_bases="N"))
    qs.append(QuerySpec("9", 1, 1 << 30, 1, 1 << 30, alternate_bases="N"))
    qs.append(QuerySpec("22", 1 << 29, 1 << 30, 1, 1 << 30))
    return qs


def _long_records():
    """Records of 10 alts (longer than the K-shift regime) and a length-
    clamped row, for the segmented-scan form and ROW_CLAMPED."""
    recs = []
    for i in range(60):
        n_alts = 10 if i % 5 == 0 else 1
        recs.append(
            VcfRecord(
                chrom="1", pos=5000 + 4 * i, ref="A",
                alts=["CGT"[j % 3] * (1 + j // 3) for j in range(n_alts)],
                vt="N/A", ac=[j % 3 for j in range(n_alts)], an=20,
                genotypes=[],
            )
        )
    recs.append(
        VcfRecord(
            chrom="1", pos=5100, ref="A" * 9000, alts=["C"], vt="N/A",
            ac=[1], an=4, genotypes=[],
        )
    )
    return recs


@pytest.fixture(scope="module")
def corpus():
    rng = random.Random(7)
    recs = random_records(
        rng, chrom="1", n=900, n_samples=4, p_symbolic=0.15,
        p_multiallelic=0.3,
    )
    recs += random_records(rng, chrom="22", n=300, n_samples=4, p_symbolic=0.1)
    recs += _long_records()
    return build_index(
        recs, dataset_id="ds0", sample_names=[f"S{i}" for i in range(4)]
    )


def _packed_inputs(jindex, shard, queries):
    enc = encode_queries(queries)
    lo, hi = _window_bounds(jindex, enc)
    q8, _ = pack_q8(enc, lo, hi)
    tile_ids = (lo // jindex.tile).astype(np.int32)
    return tile_ids, q8


def _assert_results_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if b is None:
            assert a is None, f.name
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_index_packing_matches(corpus):
    jindex = jsk.ScatterDeviceIndex(corpus, tile=128)
    tindex = tsk.ScatterDeviceIndex(shard_from_reference(corpus), "cpu")
    np.testing.assert_array_equal(tindex.tiles.numpy(), np.asarray(jindex.tiles))
    assert tindex.seg_k == jindex.seg_k == 9
    assert tindex.n_tiles == jindex.n_tiles


@pytest.mark.parametrize("form", ["shift", "scan"])
@pytest.mark.parametrize("exact_only", [True, False])
@pytest.mark.parametrize("C", [1, 2, 5, 17])
def test_twin_matches_scatter_batch(corpus, C, exact_only, form):
    """Raw (tiles, tile_ids, q8) through JAX ``_scatter_batch`` and the
    twin: equal agg and masks for every tier width C, both exact
    specialisations and both first-match forms."""
    T = 128
    cap = T if C == 1 else (C - 1) * T
    jindex = jsk.ScatterDeviceIndex(corpus, tile=T)
    qs = _queries(corpus, seed=100 + C, n=61)
    tile_ids, q8 = _packed_inputs(jindex, corpus, qs)
    # plus slots aimed at the 10-alt records and the clamped row
    lo = int(np.searchsorted(corpus.cols["pos"], 5000))
    extra = np.array([[lo + d, lo + d + 40] for d in range(0, 120, 7)])
    ex_q8 = np.zeros((len(extra), 8), np.int32)
    ex_q8[:, 0], ex_q8[:, 1] = extra[:, 0], extra[:, 1]
    ex_q8[:, 3] = (1 << 30)
    ex_q8[:, 6] = 1 | (1 << 1)  # ref wildcard, any-base alt
    ex_q8[:, 7] = -65536  # alt_len 0, max_len 0xFFFF (unbounded)
    tile_ids = np.concatenate([tile_ids, (extra[:, 0] // T).astype(np.int32)])
    q8 = np.concatenate([q8, ex_q8])
    seg_k = jindex.seg_k if form == "shift" else None
    want_agg, want_masks = jsk._scatter_batch(
        jindex.tiles, jnp.asarray(tile_ids), jnp.asarray(q8),
        T=T, CAP=cap, nslots=len(q8), C=C, exact_only=exact_only,
        seg_k=seg_k,
    )
    got_agg, got_masks = tsk.scatter_core_reference(
        torch.from_numpy(np.array(jindex.tiles)),
        torch.from_numpy(tile_ids), torch.from_numpy(q8),
        T=T, CAP=cap, C=C, exact_only=exact_only, seg_k=seg_k,
    )
    assert got_agg.dtype == got_masks.dtype == torch.int32
    np.testing.assert_array_equal(got_agg.numpy(), np.asarray(want_agg))
    np.testing.assert_array_equal(got_masks.numpy(), np.asarray(want_masks))
    assert int(np.asarray(want_agg)[:, 4].sum()) > 0  # lanes did match


def test_wrapper_runs_twin_on_cpu(corpus):
    tindex = tsk.ScatterDeviceIndex(shard_from_reference(corpus), "cpu")
    tile_ids = torch.arange(0, 40, 3, dtype=torch.int32)
    q8 = torch.zeros((len(tile_ids), 8), dtype=torch.int32)
    q8[:, 0] = tile_ids * 128
    q8[:, 1] = tile_ids * 128 + 100
    q8[:, 3] = 1 << 30
    q8[:, 6] = 3  # ref wildcard, any-base alt
    q8[:, 7] = -65536  # unbounded max_len
    telemetry.reset_launch_counts()
    agg, masks, seq = tsk.scatter_match(
        tindex.tiles, tile_ids, q8, T=128, CAP=256
    )
    want = tsk.scatter_core_reference(
        tindex.tiles, tile_ids, q8, T=128, CAP=256
    )
    assert seq is None
    assert tsk.scatter_match_launches == 0  # the twin is no launch
    assert torch.equal(agg, want[0]) and torch.equal(masks, want[1])
    with pytest.raises(ValueError):
        tsk.scatter_match(
            tindex.tiles.to("meta"), tile_ids.to("meta"), q8.to("meta"),
            T=128, CAP=256,
        )


@pytest.fixture(scope="module")
def dataset():
    rng = random.Random(7)
    recs = random_records(
        rng, chrom="1", n=900, n_samples=4, p_symbolic=0.15, p_multiallelic=0.3
    )
    recs += random_records(rng, chrom="22", n=300, n_samples=4, p_symbolic=0.1)
    shard = build_index(
        recs, dataset_id="ds0", sample_names=[f"S{i}" for i in range(4)]
    )
    return shard, shard_from_reference(shard)


def _both(shard, tshard, qs, tile, **kw):
    want = jsk.run_queries_scattered(
        jsk.ScatterDeviceIndex(shard, tile=tile), qs, **kw
    )
    got = tsk.run_queries_scattered(
        tsk.ScatterDeviceIndex(tshard, "cpu", tile=tile), qs, **kw
    )
    _assert_results_equal(got, want)
    return got


def test_run_queries_mixed(dataset):
    shard, tshard = dataset
    got = _both(
        shard, tshard, _queries(shard), 256, window_cap=256, record_cap=256
    )
    assert (~got.overflow).sum() > 20


def test_run_queries_overflow_and_record_cap(dataset):
    shard, tshard = dataset
    wide = [QuerySpec("1", 1, 1 << 30, 1, 1 << 30, alternate_bases="N")]
    assert _both(shard, tshard, wide, 256, window_cap=256).overflow[0]
    lo = int(shard.cols["pos"][0])
    q = [QuerySpec("1", lo, lo + 2000, 1, 1 << 30, alternate_bases="N")]
    got = _both(shard, tshard, q, 256, window_cap=256, record_cap=4)
    assert not got.overflow[0] and got.rows.shape == (1, 4)


def test_run_queries_large_batch_chunks(dataset):
    shard, tshard = dataset
    rng = random.Random(3)
    pos = shard.cols["pos"]
    qs = []
    for _ in range(2200):  # crosses CHUNK=2048: two chunks, one launch
        p = int(pos[rng.randrange(len(pos))])
        qs.append(
            QuerySpec(
                rng.choice(["1", "22"]), p, p, 1, 1 << 30, alternate_bases="N"
            )
        )
    _both(shard, tshard, qs, 256, window_cap=256, record_cap=16)


def test_run_queries_tier_split(dataset):
    shard, tshard = dataset
    assert len(tsk._tier_caps(tsk.ScatterDeviceIndex(tshard, "cpu"), 512)) >= 2
    pos = shard.cols["pos"]
    rng = random.Random(31)
    qs = []
    for _ in range(300):
        p = int(pos[rng.randrange(len(pos))])
        w = rng.choice([0, 0, 0, 2_000, 12_000])
        qs.append(
            QuerySpec("1", max(1, p - w), p + w, 1, 1 << 30, alternate_bases="N")
        )
    got = _both(shard, tshard, qs, 128, window_cap=512, record_cap=128)
    assert (~got.overflow).sum() > 200


def test_run_queries_record_straddling_tile():
    recs = []
    for i in range(400):
        recs.append(
            VcfRecord(
                chrom="5", pos=1000 + i * 3, ref="A",
                alts=["T"] if i % 2 else ["C", "G", "TT"],
                vt="N/A", ac=[1] if i % 2 else [1, 1, 1], an=10,
                genotypes=[],
            )
        )
    shard = build_index(recs, dataset_id="edge")
    qs = []
    for i in range(0, 400, 7):
        p = 1000 + i * 3
        qs.append(QuerySpec("5", p, p + 40, 1, 1 << 30, alternate_bases="N"))
        qs.append(QuerySpec("5", p, p, 1, 1 << 30, alternate_bases="N"))
    got = _both(
        shard, shard_from_reference(shard), qs, 128, window_cap=128,
        record_cap=64,
    )
    assert not got.overflow.any()


def test_run_queries_clamped_lengths():
    long_alt = "A" * 70_000
    recs = [
        VcfRecord(chrom="3", pos=500, ref="A", alts=[long_alt], vt="N/A",
                  ac=[2], an=8, genotypes=[]),
        VcfRecord(chrom="3", pos=600, ref="A", alts=["T"], vt="N/A",
                  ac=[1], an=8, genotypes=[]),
        VcfRecord(chrom="4", pos=100, ref="A" * 9000, alts=["C" * 8500],
                  vt="N/A", ac=[1], an=4, genotypes=[]),
        VcfRecord(chrom="4", pos=20_000, ref="A", alts=["T"], vt="N/A",
                  ac=[1], an=4, genotypes=[]),
    ]
    shard = build_index(recs, dataset_id="clamp")
    qs = [
        QuerySpec("3", 500, 500, 1, 1 << 30, alternate_bases=long_alt),
        QuerySpec("3", 400, 700, 1, 1 << 30, variant_type="INS"),
        QuerySpec("3", 550, 700, 1, 1 << 30, alternate_bases="N"),
        QuerySpec("4", 1, 10_000, 1, 1 << 30, variant_type="DEL"),
        QuerySpec("4", 1, 10_000, 1, 1 << 30, variant_type="INS"),
        QuerySpec("4", 19_000, 21_000, 1, 1 << 30, alternate_bases="N"),
    ]
    got = _both(
        shard, shard_from_reference(shard), qs, 128, window_cap=128,
        record_cap=16,
    )
    assert got.overflow.tolist() == [True, True, False, True, True, False]


def test_run_queries_non_tile_multiple_window_cap():
    rng = random.Random(7)
    recs = random_records(rng, chrom="1", n=3000, n_samples=0, spacing=8)
    shard = build_index(recs, dataset_id="wc")
    pos = shard.cols["pos"]
    qrng = random.Random(9)
    qs = []
    for _ in range(80):
        p = int(pos[qrng.randrange(len(pos))])
        qs.append(
            QuerySpec("1", max(1, p - 400), p + 400, 1, 1 << 30,
                      alternate_bases="N")
        )
    got = _both(
        shard, shard_from_reference(shard), qs, 128, window_cap=200,
        record_cap=256,
    )
    assert (~got.overflow).sum() >= 10


def test_run_queries_shift_form_equals_scan_form():
    rng = random.Random(31)
    recs = random_records(rng, chrom="1", n=500, n_samples=4, p_multiallelic=0.5)
    shard = build_index(recs, dataset_id="segk")
    tindex = tsk.ScatterDeviceIndex(shard_from_reference(shard), "cpu")
    jindex = jsk.ScatterDeviceIndex(shard, tile=128)
    assert 1 <= tindex.seg_k <= 8
    qs = _queries(shard, chroms=("1",))
    shift = tsk.run_queries_scattered(tindex, qs, window_cap=512, record_cap=64)
    _assert_results_equal(
        shift,
        jsk.run_queries_scattered(jindex, qs, window_cap=512, record_cap=64),
    )
    tindex.seg_k = jindex.seg_k = 99  # force the scan form in both
    scan = tsk.run_queries_scattered(tindex, qs, window_cap=512, record_cap=64)
    _assert_results_equal(
        scan,
        jsk.run_queries_scattered(jindex, qs, window_cap=512, record_cap=64),
    )
    _assert_results_equal(scan, shift)


def test_empty_batch():
    rng = random.Random(1)
    shard = build_index(random_records(rng, n=50), dataset_id="e")
    got = _both(shard, shard_from_reference(shard), [], 128, record_cap=8)
    assert got.rows.shape == (0, 8)
