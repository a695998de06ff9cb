"""The port's fused multi-dataset path held against the JAX package.

The JAX package builds the seeded shards; ``shard_from_reference`` hands
the same arrays to the port. The stacked index, the bisection kernel's
dispatch (``run_queries``: XLA ``_query_batch`` on the CPU against the
port's plain-PyTorch twin, which the ``bisect_query`` wrapper runs for
CPU tensors), the micro-batcher's fused submissions and the engine's
multi-dataset leg must give the JAX package's outputs exactly: every
output is an integer or a string, so the tolerance is 0. The CUDA
kernel itself is held against the twin on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses
import json
import random
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbeacon_tpu.api.envelopes import Envelopes as JEnvelopes
from sbeacon_tpu.api.requests import parse_request as j_parse_request
from sbeacon_tpu.api.variants import run_variant_search as j_run_variant_search
from sbeacon_tpu.config import BeaconConfig as JBeaconConfig
from sbeacon_tpu.config import BeaconInfo as JBeaconInfo
from sbeacon_tpu.config import EngineConfig as JEngineConfig
from sbeacon_tpu.engine import VariantEngine as JVariantEngine
from sbeacon_tpu.genomics.vcf import VcfRecord as JVcfRecord
from sbeacon_tpu.index.columnar import build_index as j_build_index
from sbeacon_tpu.index.columnar import stack_shard_columns as j_stack
from sbeacon_tpu.ops import kernel as jk
from sbeacon_tpu.payloads import VariantQueryPayload as JPayload
from sbeacon_tpu.testing import random_records as j_random_records
from sbeacon_tpu_torch import engine as t_engine
from sbeacon_tpu_torch import telemetry
from sbeacon_tpu_torch.api.envelopes import Envelopes
from sbeacon_tpu_torch.api.requests import parse_request
from sbeacon_tpu_torch.api.variants import run_variant_search
from sbeacon_tpu_torch.config import BeaconConfig, BeaconInfo, EngineConfig
from sbeacon_tpu_torch.engine import VariantEngine, host_match_rows
from sbeacon_tpu_torch.index import shard_from_reference, stack_shard_columns
from sbeacon_tpu_torch.ops import kernel as tk
from sbeacon_tpu_torch.ops import run_queries_auto
from sbeacon_tpu_torch.payloads import VariantQueryPayload
from sbeacon_tpu_torch.serving import MicroBatcher
from torch_ingest_corpus import no_thread_leak  # noqa: F401

INT32_MAX = 2**31 - 1
_OTHER_TYPES = ["INV", "INS:ME", "DUP:TANDEM:EXTRA_LONG_NAME", "SNP", None]


def _special_records():
    """Shapes the random corpus lacks: 12-alt records, symbolic alts of
    types outside the five (VT_OTHER, one longer than the 16-byte
    prefix) and a dense run whose matches exceed a small record_cap."""
    recs = []
    for i in range(30):
        recs.append(
            JVcfRecord(
                chrom="1", pos=20_000 + 7 * i, ref="AC",
                alts=[b * k for k in (1, 2, 3) for b in "ACGT"],
                vt="N/A", ac=[(i + j) % 4 for j in range(12)], an=40,
                genotypes=[],
            )
        )
    sym = ["<INV>", "<INS:ME:ALU>", "<DUP:TANDEM:EXTRA_LONG_NAME>", "<CNV>",
           "<DEL:ME>", "<CN2>"]
    for i in range(36):
        alt = sym[i % len(sym)]
        recs.append(
            JVcfRecord(
                chrom="1", pos=21_000 + 5 * i, ref="G",
                alts=[alt, "T"] if i % 3 == 0 else [alt],
                vt="SV", ac=[1, 2] if i % 3 == 0 else [3], an=10,
                genotypes=[],
            )
        )
    for i in range(300):
        recs.append(
            JVcfRecord(chrom="1", pos=30_000 + i, ref="A", alts=["T"],
                       vt="SNP", ac=[1], an=2, genotypes=[])
        )
    return recs


def _corpus():
    rng = random.Random(23)
    a = j_random_records(rng, chrom="1", n=600, n_samples=4, p_symbolic=0.2,
                         p_multiallelic=0.3)
    a += j_random_records(rng, chrom="22", n=150, n_samples=4)
    a += _special_records()
    b = j_random_records(rng, chrom="chr1", n=500, n_samples=3, spacing=20,
                         p_symbolic=0.2)
    c = j_random_records(rng, chrom="22", n=300, n_samples=0, spacing=9)
    d = j_random_records(rng, chrom="1", n=400, n_samples=0, spacing=6,
                         p_multiallelic=0.4)
    return [
        ("dsA", "a.vcf.gz", a, ["a0", "a1", "a2", "a3"]),
        ("dsB", "b.vcf.gz", b, ["b0", "b1", "b2"]),
        ("dsC", "c.vcf.gz", c, []),  # chromosome 1 is empty here
        ("dsD", "d.vcf.gz", d, []),
    ]


@pytest.fixture(scope="module")
def shards():
    return [
        j_build_index(recs, dataset_id=ds, vcf_location=vcf,
                      sample_names=names)
        for ds, vcf, recs, names in _corpus()
    ]


@pytest.fixture(scope="module")
def indexes(shards):
    jf = jk.FusedDeviceIndex(shards, pad_unit=1024)
    tf = tk.FusedDeviceIndex(
        [shard_from_reference(s) for s in shards], "cpu", pad_unit=1024
    )
    return jf, tf


def _assert_results_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if b is None:
            assert a is None, f.name
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


# -- the stacked index --------------------------------------------------------


def test_stack_shard_columns_matches(shards):
    want_cols, want_offs, want_base = j_stack(shards)
    got_cols, got_offs, got_base = stack_shard_columns(
        [shard_from_reference(s) for s in shards]
    )
    assert set(got_cols) == set(want_cols)
    for k in want_cols:
        assert got_cols[k].dtype == want_cols[k].dtype, k
        np.testing.assert_array_equal(got_cols[k], want_cols[k], err_msg=k)
    assert got_offs.dtype == want_offs.dtype == np.int32
    np.testing.assert_array_equal(got_offs, want_offs)
    assert got_base.dtype == want_base.dtype == np.int64
    np.testing.assert_array_equal(got_base, want_base)


def test_stack_shard_columns_refuses_past_int32():
    class Huge:
        n_rows = 2**30 + 1

    with pytest.raises(ValueError, match="int32"):
        stack_shard_columns([Huge(), Huge()])
    with pytest.raises(ValueError):
        stack_shard_columns([])


@pytest.mark.parametrize("pad_unit", [None, 1024, 4096])
def test_fused_index_matches(shards, pad_unit):
    """Column for column, the port's stack equals the JAX
    ``FusedDeviceIndex.arrays`` (alt_prefix as the same bit pattern),
    with the same shard_base, window_hint and n_iters."""
    jf = jk.FusedDeviceIndex(shards, pad_unit=pad_unit)
    tf = tk.FusedDeviceIndex(
        [shard_from_reference(s) for s in shards], "cpu", pad_unit=pad_unit
    )
    assert set(tf.arrays) == set(jf.arrays)
    for k, v in jf.arrays.items():
        want = np.asarray(v)
        got = tf.arrays[k].numpy()
        if want.dtype == np.uint32:
            assert got.dtype == np.int32, k
            got = got.view(np.uint32)
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    np.testing.assert_array_equal(tf.shard_base, jf.shard_base)
    assert (tf.n_rows, tf.n_padded, tf.n_iters, tf.window_hint, tf.n_shards) == (
        jf.n_rows, jf.n_padded, jf.n_iters, jf.window_hint, jf.n_shards
    )
    rows = np.array([3, 17, int(jf.shard_base[2]) + 5])
    for sid in range(len(shards)):
        np.testing.assert_array_equal(
            tf.to_local_rows(rows, sid), jf.to_local_rows(rows, sid)
        )


@pytest.mark.parametrize("floor,offs", [
    (256, [[0, 0, 10, 10]]),
    (256, [[0, 300, 300, 1000]]),
    (64, [0, 70, 70]),
    (256, np.zeros((0, 27), np.int32)),
])
def test_padding_helpers_match(floor, offs):
    assert tk.window_hint_for(offs, floor) == jk.window_hint_for(offs, floor)
    for n in (0, 1, 8191, 8192, 8193, 3_500_000):
        assert tk.padded_rows(n, 8192) == jk.padded_rows(n, 8192)
        assert tk.bisect_iters(n) == jk.bisect_iters(n)


# -- the kernel's dispatch ----------------------------------------------------


def _hit_spec(shard, i, **over):
    p = int(shard.cols["pos"][i])
    kw = dict(chrom=shard.row_chrom(i), start_min=p, start_max=p,
              end_min=1, end_max=1 << 30)
    kw.update(over)
    return jk.QuerySpec(**kw)


def _family_queries(shards, family, seed, n=40):
    """(specs, shard ids) of one predicate family, aimed at every shard
    including the one whose chromosome 1 is empty."""
    rng = random.Random(seed)
    specs, sids = [], []
    for _ in range(n):
        sid = rng.randrange(len(shards))
        sh = shards[sid]
        i = rng.randrange(sh.n_rows)
        p = int(sh.cols["pos"][i])
        w = rng.choice([0, 40, 400, 4000])
        chrom = rng.choice([sh.row_chrom(i), "1"])
        base = dict(chrom=chrom, start_min=max(1, p - w), start_max=p + w,
                    end_min=1, end_max=1 << 30)
        if family == "exact":
            spec = _hit_spec(
                sh, i,
                reference_bases=rng.choice([None, "N", sh.row_ref(i)]),
                alternate_bases=sh.row_alt(i),
            )
        elif family == "any_base":
            spec = jk.QuerySpec(
                **base, alternate_bases="N",
                reference_bases=rng.choice([None, "N", "A", "C"]),
            )
        elif family == "typed":
            spec = jk.QuerySpec(**base, variant_type=rng.choice(
                ["DEL", "INS", "DUP", "DUP:TANDEM", "CNV"]))
        elif family == "other_type":
            spec = jk.QuerySpec(**base,
                                variant_type=rng.choice(_OTHER_TYPES))
        elif family == "lengths":
            spec = jk.QuerySpec(
                **base,
                alternate_bases=rng.choice(["N", None, "AT"]),
                variant_min_length=rng.randint(0, 3),
                variant_max_length=rng.choice([-1, 1, 2, 6]),
            )
        else:  # edges
            spec = rng.choice([
                jk.QuerySpec(chrom, 1, INT32_MAX, 1, INT32_MAX,
                             alternate_bases="N"),
                jk.QuerySpec("1", 19_990, INT32_MAX, 1, 1 << 30,
                             variant_type="DUP"),
                jk.QuerySpec("1", 20_000, 20_300, 1, 1 << 30,
                             alternate_bases="N", reference_bases="AC"),
                jk.QuerySpec("1", 21_000, 21_200, 1, 1 << 30,
                             variant_type=rng.choice(_OTHER_TYPES + ["CNV"])),
                jk.QuerySpec("1", 30_000, 30_400, 29_000, 31_000,
                             alternate_bases="T"),
                jk.QuerySpec("1", p + w, p - w, 1, 1 << 30,
                             alternate_bases="N"),
                jk.QuerySpec("9", 1, INT32_MAX, 1, INT32_MAX),
                jk.QuerySpec(chrom, p, p, p + 10**6, 1, alternate_bases="N"),
            ])
        specs.append(spec)
        sids.append(sid)
    return specs, sids


_FAMILIES = ["exact", "any_base", "typed", "other_type", "lengths", "edges"]


@pytest.mark.parametrize("family", _FAMILIES)
@pytest.mark.parametrize(
    "window_cap,record_cap", [(2048, 1024), (256, 16), (64, 8), (1000, 600)]
)
def test_run_queries_matches_jax(indexes, shards, family, window_cap,
                                 record_cap):
    jf, tf = indexes
    specs, sids = _family_queries(shards, family,
                                  seed=window_cap + record_cap, n=40)
    enc = jk.encode_queries(specs, shard_ids=sids)
    want = jk.run_queries(jf, enc, window_cap=window_cap,
                          record_cap=record_cap)
    got = tk.run_queries(tf, tk.encode_queries(specs, shard_ids=sids),
                         window_cap=window_cap, record_cap=record_cap)
    _assert_results_equal(got, want)
    assert got.n_matched.sum() > 0


def test_run_queries_exercises_every_trap(indexes, shards):
    """The edge families above do reach what they aim at: overflow, more
    matches than record_cap, VT_OTHER hits on the device, an empty
    segment, and start_max = INT32_MAX without a wrap."""
    jf, tf = indexes
    specs = [
        jk.QuerySpec("1", 1, INT32_MAX, 1, INT32_MAX, alternate_bases="N"),
        jk.QuerySpec("1", 30_000, 30_400, 1, 1 << 30, alternate_bases="T"),
        jk.QuerySpec("1", 21_000, 21_200, 1, 1 << 30, variant_type="INV"),
        jk.QuerySpec("1", 21_000, 21_200, 1, 1 << 30,
                     variant_type="DUP:TANDEM:EXTRA_LONG_NAME"),
        jk.QuerySpec("1", 1, INT32_MAX, 1, INT32_MAX, alternate_bases="N"),
        jk.QuerySpec("1", 20_000, 20_300, 1, 1 << 30, alternate_bases="N"),
    ]
    sids = [0, 0, 0, 0, 2, 0]
    want = jk.run_queries(jf, jk.encode_queries(specs, shard_ids=sids),
                          window_cap=512, record_cap=64)
    got = tk.run_queries(tf, tk.encode_queries(specs, shard_ids=sids),
                         window_cap=512, record_cap=64)
    _assert_results_equal(got, want)
    assert got.overflow[0] and not got.overflow[1:].any()
    assert got.n_matched[1] > 64 and (got.rows[1] >= 0).all()
    assert got.n_matched[2] > 0 and got.n_matched[3] > 0
    assert got.n_matched[4] == 0 and (got.rows[4] == -1).all()
    # 30 records of 12 alts, 4 of them single bases: AN once per record
    assert got.n_matched[5] == 120 and got.all_alleles_count[5] == 30 * 40
    one = tk.run_queries(
        tf,
        tk.encode_queries([jk.QuerySpec("1", 20_000, 20_000, 1, 1 << 30,
                                        alternate_bases="N")],
                          shard_ids=[0]),
    )
    assert one.n_matched[0] == 4 and one.all_alleles_count[0] == 40


def test_window_clamp_decides_overflow_and_rows(indexes, shards):
    """window_cap clamps to window_hint before anything else: W decides
    overflow and the width of rows, as in the JAX package."""
    jf, tf = indexes
    assert tf.window_hint < 4096
    specs, sids = _family_queries(shards, "any_base", seed=5, n=16)
    for cap in (tf.window_hint - 1, tf.window_hint, 4096):
        got = tk.run_queries(tf, tk.encode_queries(specs, shard_ids=sids),
                             window_cap=cap, record_cap=4096)
        want = jk.run_queries(jf, jk.encode_queries(specs, shard_ids=sids),
                              window_cap=cap, record_cap=4096)
        _assert_results_equal(got, want)
        assert got.rows.shape == (16, min(cap, tf.window_hint))


def test_twin_matches_query_batch(indexes, shards):
    """The twin on raw kernel inputs equals XLA ``_query_batch`` on the
    same batch, unpadded."""
    jf, tf = indexes
    specs, sids = _family_queries(shards, "typed", seed=77, n=24)
    s2, i2 = _family_queries(shards, "other_type", seed=78, n=24)
    enc = jk.encode_queries(specs + s2, shard_ids=sids + i2)
    want = jk._query_batch(
        jf.arrays, {k: jnp.asarray(v) for k, v in enc.items()},
        window_cap=300, record_cap=100, n_iters=jf.n_iters,
    )
    q = torch.from_numpy(tk.pack_queries(enc, fused=True))
    out = tk.query_batch_reference(
        tf.columns, tf.alt_prefix, tf.offsets, q,
        window_cap=300, record_cap=100, n_iters=tf.n_iters,
    ).numpy()
    names = ["exists", "call_count", "n_variants", "all_alleles_count",
             "n_matched", "overflow"]
    for j, name in enumerate(names):
        np.testing.assert_array_equal(
            out[:, j], np.asarray(want[name]).astype(np.int32), err_msg=name
        )
    np.testing.assert_array_equal(out[:, tk.N_AGG:], np.asarray(want["rows"]))


@pytest.mark.parametrize("which", range(4))
def test_device_index_matches(shards, which):
    """The k=1 form: the port's DeviceIndex equals the JAX one, and so do
    its results."""
    shard = shards[which]
    jd = jk.DeviceIndex(shard, pad_unit=1024)
    td = tk.DeviceIndex(shard_from_reference(shard), "cpu", pad_unit=1024)
    for k, v in jd.arrays.items():
        want = np.asarray(v)
        got = td.arrays[k].numpy()
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert (td.n_iters, td.window_hint) == (jd.n_iters, jd.window_hint)
    specs = []
    for fam in ("exact", "any_base", "typed", "other_type"):
        s, _ = _family_queries([shard], fam, seed=which, n=12)
        specs += s
    _assert_results_equal(
        tk.run_queries(td, specs, window_cap=256, record_cap=32),
        jk.run_queries(jd, specs, window_cap=256, record_cap=32),
    )


def test_fused_batch_needs_shard_ids(indexes):
    _jf, tf = indexes
    with pytest.raises(ValueError, match="shard_ids"):
        tk.run_queries(tf, [jk.QuerySpec("1", 1, 10, 1, 10)])


def test_pack_queries_layout(shards):
    specs, sids = _family_queries(shards, "other_type", seed=3, n=10)
    enc = tk.encode_queries(specs, shard_ids=sids)
    q = tk.pack_queries(enc, fused=True)
    assert q.dtype == np.int32 and q.shape == (10, tk.N_QFIELDS)
    np.testing.assert_array_equal(q[:, tk.QF_SHARD], sids)
    np.testing.assert_array_equal(
        q[:, tk.QF_VPREFIX:tk.QF_VPREFIX + 4].view(np.uint32), enc["vprefix"]
    )
    np.testing.assert_array_equal(
        q[:, tk.QF_VMASK:tk.QF_VMASK + 4].view(np.uint32), enc["vprefix_mask"]
    )
    want = jk.encode_queries(specs, shard_ids=sids)
    for k in want:
        np.testing.assert_array_equal(enc[k], want[k], err_msg=k)
    assert not tk.pack_queries(enc, fused=False)[:, tk.QF_SHARD].any()


def test_wrapper_runs_twin_on_cpu(indexes, shards):
    _jf, tf = indexes
    specs, sids = _family_queries(shards, "any_base", seed=9, n=8)
    q = torch.from_numpy(
        tk.pack_queries(tk.encode_queries(specs, shard_ids=sids), fused=True)
    )
    telemetry.reset_launch_counts()
    out, seq = tk.bisect_query(
        tf.columns, tf.alt_prefix, tf.offsets, q,
        window_cap=256, record_cap=64, n_iters=tf.n_iters,
    )
    assert seq is None
    assert tk.bisect_query_launches == 0  # the twin is no launch
    assert torch.equal(out, tk.query_batch_reference(
        tf.columns, tf.alt_prefix, tf.offsets, q,
        window_cap=256, record_cap=64, n_iters=tf.n_iters,
    ))
    with pytest.raises(ValueError):
        tk.bisect_query(
            tf.columns.to("meta"), tf.alt_prefix.to("meta"),
            tf.offsets.to("meta"), q.to("meta"),
            window_cap=256, record_cap=64, n_iters=tf.n_iters,
        )
    empty = tk.run_queries(tf, tk.encode_queries([], shard_ids=[]),
                           record_cap=8)
    assert empty.rows.shape[0] == 0 and empty.exists.dtype == bool


def test_run_queries_auto_routes_by_index(indexes, shards):
    _jf, tf = indexes
    specs, sids = _family_queries(shards, "any_base", seed=4, n=6)
    enc = tk.encode_queries(specs, shard_ids=sids)
    _assert_results_equal(
        run_queries_auto(tf, enc, window_cap=512, record_cap=64),
        tk.run_queries(tf, enc, window_cap=512, record_cap=64),
    )


# -- the micro-batcher --------------------------------------------------------


def _point_specs(shard, n, seed):
    rng = random.Random(seed)
    pos = shard.cols["pos"]
    out = []
    for _ in range(n):
        p = int(pos[rng.randrange(len(pos))])
        out.append(jk.QuerySpec(shard.row_chrom(0), max(1, p - 50), p + 50,
                                1, 1 << 30, alternate_bases="N"))
    return out


def test_submit_many_one_launch_and_row_slices(indexes, shards):
    """submit_many rides a whole multi-shard submission in ONE launch
    and hands back one row per spec, in order."""
    _jf, tf = indexes
    specs = [_point_specs(s, 1, seed=13 + i)[0] for i, s in enumerate(shards)]
    mb = MicroBatcher(max_batch=64, max_wait_ms=0)
    try:
        res = mb.submit_many(tf, specs, shard_ids=[0, 1, 2, 3],
                             window_cap=256, record_cap=64)
        occ = mb.occupancy()
        assert occ["launches"] == 1
        assert occ["submits"] == 1 and occ["specs"] == 4
        assert occ["fused_hist"] == {4: 1}
        want = tk.run_queries(
            tf, tk.encode_queries(specs, shard_ids=[0, 1, 2, 3]),
            window_cap=256, record_cap=64,
        )
        _assert_results_equal(res, want)
        for i, sid in enumerate([0, 1, 2, 3]):
            rows = tf.to_local_rows(res.rows[i][res.rows[i] >= 0], sid)
            np.testing.assert_array_equal(
                rows, host_match_rows(shard_from_reference(shards[sid]),
                                      specs[i])
            )
    finally:
        mb.close()


def test_cross_dataset_submits_share_accumulator(indexes, shards):
    """Concurrent single-spec submits for DIFFERENT shards coalesce into
    shared launches on the fused index."""
    _jf, tf = indexes
    mb = MicroBatcher(max_batch=64, max_wait_ms=25)
    n = 16
    results = [None] * n
    errs = []

    def worker(i):
        sid = i % 4
        spec = _point_specs(shards[sid], 1, seed=300 + i)[0]
        try:
            results[i] = (sid, spec, mb.submit(
                tf, spec, shard_id=sid, window_cap=256, record_cap=256))
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not errs
        occ = mb.occupancy()
        assert occ["submits"] == n
        assert occ["launches"] < n  # coalescing engaged
        for sid, spec, res in results:
            rows = tf.to_local_rows(res.rows[0][res.rows[0] >= 0], sid)
            np.testing.assert_array_equal(
                rows, host_match_rows(shard_from_reference(shards[sid]), spec)
            )
    finally:
        mb.close()


# -- the engine ---------------------------------------------------------------


_ENGINES: dict = {}


def _engines(shards, microbatch, window_cap=2048, record_cap=1024):
    key = (microbatch, window_cap, record_cap)
    if key not in _ENGINES:
        jeng = JVariantEngine(JBeaconConfig(engine=JEngineConfig(
            use_mesh=False, response_cache=False, microbatch=microbatch,
            window_cap=window_cap, record_cap=record_cap,
        )))
        teng = VariantEngine(BeaconConfig(engine=EngineConfig(
            microbatch=microbatch, window_cap=window_cap,
            record_cap=record_cap,
        )), device="cpu")
        for s in shards:
            jeng.add_index(s)
            teng.add_index(shard_from_reference(s))
        jeng._fused_ready(wait=True)
        assert teng.warm_fused() is not None
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
    """Multi-dataset payloads of every kind: no datasetIds or several,
    points that hit, brackets of every width (wide ones overflow to the
    host), typed queries including types outside the five, length
    bounds, every granularity."""
    rng = random.Random(seed)
    base = shards[0]
    pos = base.cols["pos"]
    out = []
    for _ in range(n):
        i = rng.randrange(len(pos))
        p = int(pos[i])
        kind = rng.randrange(6)
        if kind == 0:
            kw = dict(start_min=p, start_max=p, end_min=p,
                      end_max=p + len(base.row_ref(i)) + 5,
                      reference_bases=base.row_ref(i),
                      alternate_bases=base.row_alt(i))
        else:
            w = rng.choice([0, 30, 300, 3000, 30000])
            kw = dict(start_min=max(1, p - w), start_max=p + w, end_min=0,
                      end_max=10**9,
                      reference_bases=rng.choice([None, "N", "A", "C"]))
            if kind == 1:
                kw["alternate_bases"] = "N"
            elif kind == 2:
                kw["variant_type"] = rng.choice(
                    ["DEL", "INS", "DUP", "DUP:TANDEM", "CNV"] + _OTHER_TYPES)
            elif kind == 3:
                kw["alternate_bases"] = rng.choice("ACGT")
            elif kind == 4:
                kw["alternate_bases"] = "N"
                kw["variant_min_length"] = rng.randint(0, 2)
                kw["variant_max_length"] = rng.choice([-1, 1, 4])
            else:
                kw["alternate_bases"] = rng.choice(["N", "AT", "<DEL>"])
        out.append(dict(
            dataset_ids=rng.choice([[], ["dsA", "dsB"], ["dsA", "dsB", "dsD"],
                                    ["dsB", "dsD"]]),
            reference_name=rng.choice(["1", "1", "22"]),
            requested_granularity=rng.choice(
                ["boolean", "count", "record", "aggregated"]),
            include_datasets=rng.choice(["NONE", "HIT", "ALL", "MISS"]),
            include_samples=rng.random() < 0.5,
            **kw,
        ))
    return out


def _asdicts(responses):
    return [dataclasses.asdict(r) for r in responses]


@pytest.mark.parametrize(
    "microbatch,window_cap,record_cap",
    [(True, 2048, 1024), (False, 2048, 1024), (True, 256, 16),
     (False, 64, 8)],
)
def test_search_matches_jax_engine(shards, microbatch, window_cap,
                                   record_cap):
    jeng, teng = _engines(shards, microbatch, window_cap, record_cap)
    fused0, fallbacks0 = teng.fused_searches, teng.host_fallbacks
    for doc in _payloads(shards, seed=window_cap + record_cap, n=50):
        want = jeng.search(JPayload(**doc))
        got = teng.search(VariantQueryPayload(**doc))
        assert _asdicts(got) == _asdicts(want), doc
    assert teng.fused_searches - fused0 >= 15  # the fused leg served
    if window_cap < 2048:
        assert teng.host_fallbacks > fallbacks0  # and overflowed


def test_search_selected_samples(shards):
    """Selected-samples requests on two engines, both against the JAX
    engine: one with the planes on the device, one whose planes stay on
    the host (device_planes off, as when the budget gate refuses them)."""
    jeng, teng = _engines(shards, True)
    host_planes = VariantEngine(BeaconConfig(engine=EngineConfig(
        device_planes=False)), device="cpu")
    try:
        for s in shards:
            host_planes.add_index(shard_from_reference(s))
        assert host_planes.warm_fused() is not None
        rng = random.Random(5)
        pos = shards[0].cols["pos"]
        fused0 = teng.fused_searches
        for _ in range(25):
            p = int(pos[rng.randrange(len(pos))])
            doc = dict(
                dataset_ids=["dsA", "dsB"], reference_name="1",
                reference_bases=rng.choice(["N", "A", "AN", None]),
                alternate_bases=rng.choice(["N", None, "G"]),
                start_min=max(1, p - 400), start_max=p + 400,
                end_min=0, end_max=10**9,
                requested_granularity=rng.choice(["count", "record"]),
                include_datasets="HIT", include_samples=True,
                sample_names={"dsA": ["a1", "a3"], "dsB": ["b0"]},
                selected_samples_only=True,
            )
            want = _asdicts(jeng.search(JPayload(**doc)))
            for eng in (teng, host_planes):
                got = eng.search(VariantQueryPayload(**doc))
                assert _asdicts(got) == want, (eng.config.engine, doc)
        # device planes: the fused match + planes kernel serves each
        # target whole and the stack never pre-matches them (the JAX
        # engine's exclusion)
        assert all(p is not None for _d, _v, (_s, _i, p)
                   in teng.indexes_for(["dsA", "dsB"]))
        assert teng.fused_searches == fused0
        # host planes: the stack pre-matches the rows (ref_wildcard) and
        # materialisation reads the host planes
        assert all(p is None for _d, _v, (_s, _i, p)
                   in host_planes.indexes_for(["dsA", "dsB"]))
        assert host_planes.fused_searches > 0
    finally:
        host_planes.close()


def _bodies():
    rng = random.Random(19)
    out = []
    for k in range(24):
        start = rng.randint(1000, 9000)
        gran = ["boolean", "count", "record", "aggregated"][k % 4]
        rp = {
            "assemblyId": "GRCh38",
            "referenceName": rng.choice(["1", "chr1", "22"]),
            "start": [start] if k % 3 else [start, start + 500],
            "end": [start + 2000] if k % 3 else [start, start + 4000],
        }
        pick = k % 6
        if pick == 0:
            rp.update(referenceBases="n", alternateBases="N")
        elif pick == 1:
            rp.update(alternateBases=rng.choice("acgt"))
        elif pick == 2:
            rp.update(variantType=rng.choice(["del", "DUP", "CNV", "INV"]))
        elif pick == 3:
            rp.update(alternateBases="N", variantMinLength=1,
                      variantMaxLength=3)
        elif pick == 4:
            rp.update(variantType="INS:ME")
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
    jeng, teng = _engines(shards, microbatch)
    datasets = [{"id": "dsA"}, {"id": "dsB"}, {"id": "dsC"}, {"id": "dsD"}]
    jenv = JEnvelopes(JBeaconInfo())
    tenv = Envelopes(BeaconInfo())
    fused0 = teng.fused_searches
    for body in _bodies():
        outs = []
        for parse, run, eng, env in (
            (j_parse_request, j_run_variant_search, jeng, jenv),
            (parse_request, run_variant_search, teng, tenv),
        ):
            req = parse("POST", None, body)
            s_min, s_max, e_min, e_max = req.coordinates()
            agg = run(eng, datasets, req, start_min=s_min, start_max=s_max,
                      end_min=e_min, end_max=e_max)
            outs.append(json.dumps(
                env.by_granularity(
                    req.granularity, exists=agg.exists,
                    count=len(agg.variants),
                    results=agg.results[req.skip : req.skip + req.limit],
                    set_type="genomicVariant", skip=req.skip, limit=req.limit,
                ),
                sort_keys=True,
            ))
        assert outs[0] == outs[1], body
    assert teng.fused_searches > fused0


def _fresh_engine(shards, **cfg):
    teng = VariantEngine(BeaconConfig(engine=EngineConfig(**cfg)),
                         device="cpu")
    for s in shards:
        teng.add_index(shard_from_reference(s))
    return teng


_WIDE = dict(dataset_ids=[], reference_name="1", start_min=1,
             start_max=25_000, end_min=0, end_max=10**9,
             alternate_bases="N", requested_granularity="count",
             include_datasets="HIT", no_response_cache=True)


def test_background_build_then_fused(shards):
    """The first multi-dataset request starts the build off the request
    path and is served per shard; once the build publishes, requests
    ride one fused launch; add_index marks the stack stale."""
    jeng, _ = _engines(shards, False)
    want = _asdicts(jeng.search(JPayload(**_WIDE)))
    teng = _fresh_engine(shards, microbatch=False)
    try:
        assert _asdicts(teng.search(VariantQueryPayload(**_WIDE))) == want
        for t in list(teng._fused_builds):
            t.join()
        assert _asdicts(teng.search(VariantQueryPayload(**_WIDE))) == want
        assert teng.fused_searches == 1
        teng.add_index(shard_from_reference(shards[3]))
        assert teng._fused_dirty
        assert _asdicts(teng.search(VariantQueryPayload(**_WIDE))) == want
        assert teng.fused_searches == 1  # the rebuild is in flight
    finally:
        teng.close()


def test_failed_fused_build_raises(shards, monkeypatch):
    """A failed background build is not served around: the next
    multi-dataset request raises it; an inline build raises directly;
    a publish clears it."""
    teng = _fresh_engine(shards, microbatch=False)

    def boom(*_a, **_k):
        raise MemoryError("device out of memory")

    monkeypatch.setattr(t_engine, "FusedDeviceIndex", boom)
    try:
        payload = VariantQueryPayload(**_WIDE)
        teng.search(payload)  # starts the build; the build is in flight
        for t in list(teng._fused_builds):
            t.join()
        with pytest.raises(RuntimeError, match="failed to build") as ei:
            teng.search(payload)
        assert isinstance(ei.value.__cause__, MemoryError)
        single = VariantQueryPayload(**{**_WIDE, "dataset_ids": ["dsA"]})
        assert len(teng.search(single)) == 1  # one dataset needs no stack
        with pytest.raises(MemoryError):
            teng.warm_fused()
        monkeypatch.undo()
        assert teng.warm_fused() is not None
        teng.search(payload)
        assert teng.fused_searches == 1
    finally:
        teng.close()


def test_fused_max_rows_serves_per_shard(shards):
    """A stack over the row budget is skipped, not failed: per-shard
    dispatch serves, with the same answers."""
    jeng, _ = _engines(shards, False)
    teng = _fresh_engine(shards, microbatch=False, fused_max_rows=100)
    try:
        assert teng.warm_fused() is None
        got = teng.search(VariantQueryPayload(**_WIDE))
        assert _asdicts(got) == _asdicts(jeng.search(JPayload(**_WIDE)))
        assert teng.fused_searches == 0
    finally:
        teng.close()
