"""The port's dataset-sharded stack held against the JAX package.

The JAX side runs on the suite's eight forced CPU devices
(tests/conftest.py); the port runs on meshes of 1, 2 and 8 CPU entries
(``make_mesh(devices=[cpu] * n)``), where the stacked kernels' wrappers
run their plain-PyTorch twins. The same seeded shards (built by the JAX
package, handed to the port by ``shard_from_reference``) and queries go
through ``StackedIndex``, ``sharded_query``, ``sharded_selected_query``
and ``_plane_reduce`` on both sides. Every output is an integer or a
bool: the tolerance is 0. The CUDA kernels themselves are held against
the twins on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbeacon_tpu.genomics.vcf import VcfRecord
from sbeacon_tpu.index.columnar import build_index as j_build_index
from sbeacon_tpu.ops.kernel import QuerySpec as JQuerySpec
from sbeacon_tpu.parallel import mesh as jm
from sbeacon_tpu.testing import random_records as j_random_records
from sbeacon_tpu_torch.engine import host_match_rows, materialize_response
from sbeacon_tpu_torch.index import shard_from_reference
from sbeacon_tpu_torch.index.columnar import FLAG
from sbeacon_tpu_torch.ops import scatter_kernel as tsk
from sbeacon_tpu_torch.ops.kernel import QuerySpec, encode_queries
from sbeacon_tpu_torch.ops.kernel import pack_queries
from sbeacon_tpu_torch.ops.plane_kernel import (
    PlaneDeviceIndex,
    sample_mask_words,
)
from sbeacon_tpu_torch.parallel import mesh as tm
from sbeacon_tpu_torch.payloads import VariantQueryPayload

CPU = torch.device("cpu")
D_PAD = 8  # splits over the port's 1-, 2- and 8-entry meshes and JAX's 8


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return jm.make_mesh(8)


def _tmesh(n):
    return tm.make_mesh(devices=[CPU] * n)


def _query_shards():
    """test_parallel.py's corpus: three datasets over chromosomes 1 and
    22, four samples."""
    out = []
    for seed in range(3):
        rng = random.Random(seed)
        recs = j_random_records(rng, chrom="1", n=300, n_samples=4)
        recs += j_random_records(rng, chrom="22", n=200, start=500,
                                 n_samples=4)
        out.append(j_build_index(
            recs, dataset_id=f"ds{seed}", vcf_location=f"vcf{seed}",
            sample_names=[f"S{i}" for i in range(4)],
        ))
    return out


def _plane_shards():
    """test_mesh_serving.py's plane corpus: five datasets of seven
    samples, INFO-sourced and genotype-derived counts alternating, plus
    ploidy > 2 rows and 12-alt records in dataset 0."""
    names = [f"S{i}" for i in range(7)]
    out = []
    for d in range(5):
        rng = random.Random(700 + d)
        recs = j_random_records(rng, chrom="7", n=250, n_samples=len(names),
                                p_no_acan=0.5 if d % 2 else 0.0)
        if d == 0:
            for rec in recs[::11]:
                rec.genotypes[rng.randrange(len(names))] = "1|1|1"
                rec.ac = rec.an = None
            for i in range(6):
                recs.append(VcfRecord(
                    chrom="7", pos=recs[-1].pos + 5, ref="AC",
                    alts=[b * k for k in (1, 2, 3) for b in "ACGT"],
                    vt="N/A", ac=None if i % 2 else [1] * 12,
                    an=None if i % 2 else 14,
                    genotypes=[f"{rng.randint(0, 12)}/{rng.randint(0, 12)}"
                               for _ in names],
                ))
        out.append(j_build_index(recs, dataset_id=f"p{d}",
                                 vcf_location=f"v{d}", sample_names=names))
    return out


@pytest.fixture(scope="module")
def qshards():
    return _query_shards()


@pytest.fixture(scope="module")
def pshards():
    return _plane_shards()


def _port(shards):
    return [shard_from_reference(s) for s in shards]


QUERIES = [
    ("1", 1, 10_000_000, dict()),
    ("22", 1, 10_000_000, dict(variant_type="DEL")),
    ("1", 1000, 2000, dict(alternate_bases="N")),
    ("17", 1, 10_000_000, dict()),  # absent chromosome
    ("1", 1, 10_000_000, dict(alternate_bases="N")),  # wider than caps
    ("22", 500, 3000, dict(variant_type="CNV")),
    ("1", 1, 10_000_000, dict(variant_type="INV")),  # VT_OTHER
    ("1", 3000, 6000, dict(alternate_bases="N", reference_bases="A")),
    ("22", 1, 10_000_000, dict(alternate_bases="N", variant_min_length=2,
                               variant_max_length=4)),
]


def _specs(cls, queries=QUERIES):
    return [cls(c, a, b, 1, 10_000_000, **kw) for c, a, b, kw in queries]


def _point_specs(cls, shard, n, seed, width=150, chrom="7"):
    """Any-base brackets around random rows of ``shard``."""
    rng = random.Random(seed)
    pos = shard.cols["pos"]
    out = []
    for _ in range(n):
        p = int(pos[rng.randrange(len(pos))])
        out.append(cls(chrom, max(1, p - width), p + width, 1, 1 << 30,
                       alternate_bases="N"))
    return out


def _assert_leaves(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


# -- the mesh and the host stack ---------------------------------------------


def test_make_mesh_selection(monkeypatch):
    m = tm.make_mesh(2, devices=[CPU] * 3)
    assert m.size == 2 and m.devices == (CPU, CPU) and m.axis == tm.AXIS
    with pytest.raises(ValueError, match="0 devices"):
        tm.make_mesh(devices=[])
    with pytest.raises(ValueError, match="only 1 available"):
        tm.make_mesh(2, devices=[CPU])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.make_mesh()
    assert tm.mesh_devices("cpu") == [CPU]


@pytest.mark.parametrize("kind", ["no_planes", "gt_only", "count_planes",
                                  "no_samples"])
@pytest.mark.parametrize("d_pad", [None, 8])
def test_stacked_index_arrays_byte_equal(pshards, qshards, kind, d_pad):
    if kind == "no_samples":
        shards = [j_build_index(
            j_random_records(random.Random(s), chrom="1", n=120,
                             n_samples=0), dataset_id=f"e{s}")
            for s in range(3)]
    elif kind == "gt_only":
        shards = [dataclasses.replace(s, gt_bits2=None, tok_bits1=None,
                                      tok_bits2=None) for s in pshards]
    else:
        shards = pshards if kind != "no_planes" else qshards
    with_planes = kind != "no_planes"
    want = jm.StackedIndex(shards, n_datasets_padded=d_pad, pad_unit=1024,
                           with_planes=with_planes)
    got = tm.StackedIndex(_port(shards), n_datasets_padded=d_pad,
                          pad_unit=1024, with_planes=with_planes)
    for attr in ("n_datasets", "n_datasets_padded", "n_padded", "n_iters",
                 "plane_words", "has_planes", "has_count_planes"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert set(got.arrays) == set(want.arrays)
    for k, v in want.arrays.items():
        assert got.arrays[k].dtype == v.dtype, k
        assert got.arrays[k].tobytes() == np.asarray(v).tobytes(), k
    assert got.has_planes == (kind in ("gt_only", "count_planes"))


def test_stacked_index_rejects_bad_shapes(qshards):
    with pytest.raises(ValueError):
        tm.StackedIndex([])
    with pytest.raises(ValueError):
        tm.StackedIndex(_port(qshards), n_datasets_padded=2)
    stack = tm.StackedIndex(_port(qshards), n_datasets_padded=3)
    with pytest.raises(ValueError, match="do not split"):
        stack.shard_to_mesh(_tmesh(2))


def test_plane_bytes_per_device_counts_real_words(pshards):
    shards = _port(pshards)
    W = max(s.gt_bits.shape[1] for s in shards)
    n_pad = 8192  # DeviceIndex.PAD_UNIT covers every shard here
    got = tm.StackedIndex.plane_bytes_per_device(
        shards, n_datasets_padded=8, n_mesh=2)
    assert got == 4 * n_pad * W * 4 * 4
    # XLA's TPU layout pads W to 128 lanes; the card does not
    assert got * 128 // W == jm.StackedIndex.plane_bytes_per_device(
        pshards, n_datasets_padded=8, n_mesh=2)
    no_planes = [dataclasses.replace(s, gt_bits=None) for s in shards]
    assert tm.StackedIndex.plane_bytes_per_device(
        no_planes, n_datasets_padded=8, n_mesh=2) == 0
    stack = tm.StackedIndex(shards, n_datasets_padded=8, with_planes=True)
    blocks = stack.shard_to_mesh(_tmesh(2))
    assert sum(p.numel() * 4 for p in blocks[0].planes) == got


@pytest.mark.parametrize("fits", [True, False])
def test_plane_budget_verdict_matches(fits):
    args = (1000, 500, 2000.0 if fits else 1200.0)
    assert tm.plane_budget_verdict(*args) == jm.plane_budget_verdict(*args)
    assert tm.plane_budget_verdict(*args)["fits"] is fits


def test_shard_to_mesh_layout(qshards):
    stack = tm.StackedIndex(_port(qshards), n_datasets_padded=D_PAD)
    blocks = stack.shard_to_mesh(_tmesh(4))
    assert len(blocks) == 4
    for g, blk in enumerate(blocks):
        assert blk.n_datasets == 2 and blk.n_pad == stack.n_padded
        for i, name in enumerate(tm.COLUMNS):
            np.testing.assert_array_equal(
                blk.columns[:, i].numpy(), stack.arrays[name][2 * g : 2 * g + 2])
        np.testing.assert_array_equal(
            blk.alt_prefix.numpy().view(np.uint32),
            stack.arrays["alt_prefix"][2 * g : 2 * g + 2])
        assert blk.planes is None


# -- sharded_query (J7, query-only) --------------------------------------------


@pytest.mark.parametrize("n_mesh", [1, 2, 8])
@pytest.mark.parametrize("caps", [(2048, 1024), (64, 8)])
def test_sharded_query_matches_jax(qshards, jmesh, n_mesh, caps):
    window_cap, record_cap = caps
    jstack = jm.StackedIndex(qshards, n_datasets_padded=D_PAD)
    want = jm.sharded_query(
        jstack.shard_to_mesh(jmesh), _specs(JQuerySpec), mesh=jmesh,
        n_iters=jstack.n_iters, window_cap=window_cap, record_cap=record_cap)
    tstack = tm.StackedIndex(_port(qshards), n_datasets_padded=D_PAD)
    mesh = _tmesh(n_mesh)
    got = tm.sharded_query(
        tstack.shard_to_mesh(mesh), _specs(QuerySpec), mesh=mesh,
        n_iters=tstack.n_iters, window_cap=window_cap, record_cap=record_cap)
    _assert_leaves(got[0], want[0])
    _assert_leaves(got[1], want[1])
    if window_cap == 64:
        assert got[1]["n_overflow"].sum() > 0


def test_sharded_query_aggregates_only(qshards):
    stack = tm.StackedIndex(_port(qshards), n_datasets_padded=D_PAD)
    mesh = _tmesh(2)
    blocks = stack.shard_to_mesh(mesh)
    full = tm.sharded_query(blocks, _specs(QuerySpec), mesh=mesh,
                            n_iters=stack.n_iters)
    per, agg = tm.sharded_query(blocks, _specs(QuerySpec), mesh=mesh,
                                n_iters=stack.n_iters, aggregates_only=True)
    assert per == {}
    _assert_leaves(agg, full[1])
    with pytest.raises(ValueError, match="not sharded over this mesh"):
        tm.sharded_query(blocks, _specs(QuerySpec), mesh=_tmesh(4),
                         n_iters=stack.n_iters)


def _host_truth(shards, spec):
    total_calls = total_an = total_variants = hits = 0
    for s in shards:
        rows = host_match_rows(s, spec)
        ac = s.cols["ac"][rows]
        calls = int(ac.sum())
        total_calls += calls
        total_variants += int((ac != 0).sum())
        for r in np.unique(s.cols["rec_id"][rows]):
            first_row = int(np.flatnonzero(s.cols["rec_id"] == r)[0])
            total_an += int(s.cols["an"][first_row])
        hits += int(calls > 0)
    return total_calls, total_an, total_variants, hits


@pytest.mark.parametrize("n_mesh", [1, 2, 8])
def test_sharded_matches_host_oracle(qshards, n_mesh):
    shards = _port(qshards)
    stack = tm.StackedIndex(shards, n_datasets_padded=D_PAD)
    mesh = _tmesh(n_mesh)
    specs = _specs(QuerySpec)[:4]
    _per, agg = tm.sharded_query(stack.shard_to_mesh(mesh), specs, mesh=mesh,
                                 n_iters=stack.n_iters)
    for qi, spec in enumerate(specs):
        calls, an, nvar, hits = _host_truth(shards, spec)
        assert int(agg["call_count"][qi]) == calls, spec
        assert int(agg["all_alleles_count"][qi]) == an, spec
        assert int(agg["n_variants"][qi]) == nvar, spec
        assert int(agg["n_datasets_hit"][qi]) == hits, spec
        assert bool(agg["exists"][qi]) == (calls > 0)


@pytest.mark.parametrize("n_mesh", [1, 8])
def test_padded_datasets_are_silent(qshards, n_mesh):
    stack = tm.StackedIndex(_port(qshards), n_datasets_padded=D_PAD)
    mesh = _tmesh(n_mesh)
    per, _ = tm.sharded_query(stack.shard_to_mesh(mesh), _specs(QuerySpec),
                              mesh=mesh, n_iters=stack.n_iters)
    assert not per["exists"][3:].any()
    assert per["call_count"][3:].sum() == 0
    assert (per["n_matched"][3:] == 0).all()
    assert (per["rows"][3:] == -1).all()


@pytest.mark.parametrize("n_mesh", [2, 8])
def test_per_dataset_rows_match_host(qshards, n_mesh):
    shards = _port(qshards)
    stack = tm.StackedIndex(shards, n_datasets_padded=D_PAD)
    mesh = _tmesh(n_mesh)
    spec = _specs(QuerySpec)[2]
    per, _ = tm.sharded_query(stack.shard_to_mesh(mesh), [spec], mesh=mesh,
                              n_iters=stack.n_iters)
    checked = 0
    for d, s in enumerate(shards):
        if per["overflow"][d, 0]:
            continue
        got = per["rows"][d, 0]
        np.testing.assert_array_equal(got[got >= 0], host_match_rows(s, spec))
        checked += 1
    assert checked == len(shards)


def test_stacked_query_twin_runs_per_dataset(qshards):
    """The query-only twin is the bisection twin once per local dataset
    with the int32 sums over datasets; the wrapper runs it on a CPU
    tensor and records no launch."""
    from sbeacon_tpu_torch import telemetry
    from sbeacon_tpu_torch.ops import kernel as tk

    stack = tm.StackedIndex(_port(qshards), n_datasets_padded=4)
    (blk,) = stack.shard_to_mesh(_tmesh(1))
    q = torch.from_numpy(pack_queries(encode_queries(_specs(QuerySpec)),
                                      fused=False))
    telemetry.reset_launch_counts()
    out, agg, seq = tm.stacked_query(blk.columns, blk.alt_prefix,
                                     blk.offsets, q, window_cap=256,
                                     record_cap=32, n_iters=stack.n_iters)
    assert seq is None and tm.stacked_query_launches == 0
    for d in range(4):
        want = tk.query_batch_reference(
            blk.columns[d], blk.alt_prefix[d], blk.offsets[d : d + 1], q,
            window_cap=256, record_cap=32, n_iters=stack.n_iters)
        assert torch.equal(out[d], want)
    assert out.shape == (4, len(QUERIES), tk.N_AGG + 32)
    np.testing.assert_array_equal(
        agg.numpy(), out[:, :, [1, 3, 2, 0, 5]].sum(dim=0).numpy())


# -- the plane reduction (J5) ---------------------------------------------------


def _reduce_inputs(seed, case, B=4, R=24, W=3):
    """Gathered inputs of one plane reduction: rows sorted into records,
    a valid prefix per query, AC_INFO/AN_INFO mixed, masked planes."""
    g = np.random.default_rng(seed)
    n_valid = g.integers(0, R + 1, B)
    if case == "all_invalid":
        n_valid[:] = 0
    if case == "full":
        n_valid[:] = R
    rec = np.sort(g.integers(0, R // 2, (B, R)), axis=1).astype(np.int32)
    if case == "one_record":
        rec[:] = 7
    info = FLAG.AC_INFO | FLAG.AN_INFO
    flags = np.where(g.random((B, R)) < 0.5, info, 0)
    flags = flags | np.where(g.random((B, R)) < 0.2, FLAG.AC_INFO, 0)
    if case == "info_only":
        flags[:] = info
    ac = g.integers(0, 4, (B, R)).astype(np.int32)
    an = g.integers(0, 20, (B, R)).astype(np.int32)
    if case == "zero_ac":
        ac[:, : R // 2] = 0
    planes = [
        (g.integers(0, 2**32, (B, R, W), dtype=np.uint64)
         & g.integers(0, 2**32, (B, R, W), dtype=np.uint64)).astype(
             np.uint32).view(np.int32)
        for _ in range(4)
    ]
    if case == "sparse_bits":
        planes = [np.where(g.random((B, R, W)) < 0.05, p, 0) for p in planes]
    valid = np.arange(R)[None, :] < n_valid[:, None]
    return (flags.astype(np.int32), ac, an, rec, *planes, valid)


REDUCE_CASES = ["random", "all_invalid", "full", "one_record", "info_only",
                "zero_ac", "sparse_bits"]


@pytest.mark.parametrize("case", REDUCE_CASES)
@pytest.mark.parametrize("has_counts", [True, False])
@pytest.mark.parametrize("use_counts", [None, "mixed"])
def test_plane_reduce_matches_jax(case, has_counts, use_counts):
    inputs = _reduce_inputs(len(case) * 7 + has_counts, case)
    flags, ac, an, rec, gt, gt2, tok1, tok2, valid = inputs
    uc = None if use_counts is None else np.array([True, False, True, False])
    want = jm._plane_reduce(
        jnp.asarray(flags), jnp.asarray(ac), jnp.asarray(an),
        jnp.asarray(rec), jnp.asarray(gt),
        jnp.asarray(gt2) if has_counts else None,
        jnp.asarray(tok1) if has_counts else None,
        jnp.asarray(tok2) if has_counts else None,
        jnp.asarray(valid), has_counts=has_counts,
        use_counts=None if uc is None else jnp.asarray(uc),
    )
    t = torch.from_numpy
    got = tm.plane_reduce_reference(
        t(flags), t(ac), t(an), t(rec), t(gt),
        t(gt2) if has_counts else None, t(tok1) if has_counts else None,
        t(tok2) if has_counts else None, t(valid), has_counts=has_counts,
        use_counts=None if uc is None else t(uc),
    )
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == torch.int32, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_plane_reduce_matches_scatter_selected_twin(pshards):
    """J2's twin (``scatter_selected_reference`` through
    ``run_selected_scattered``) and J5's agree on the same matched rows:
    the popcounts where rows >= 0 with counts, and the sample-hit words
    always (ROADMAP: J2 must agree with J5)."""
    shard = shard_from_reference(pshards[0])
    sindex = tsk.ScatterDeviceIndex(shard, CPU)
    pindex = PlaneDeviceIndex(shard, CPU)
    assert pindex.has_counts
    specs = _point_specs(QuerySpec, shard, 24, seed=3, width=400)
    g = np.random.default_rng(4)
    W = pindex.n_words
    masks = np.where(g.random((len(specs), W)) < 0.5, 0xFFFFFFFF,
                     g.integers(0, 2**32, (len(specs), W))).astype(np.uint32)
    masks[::5] = 0
    for with_counts in (True, False):
        res = tsk.run_selected_scattered(
            sindex, pindex, specs, masks, window_cap=2048, record_cap=64,
            with_counts=with_counts)
        rows = res.rows
        valid = rows >= 0
        safe = np.clip(rows, 0, shard.n_rows - 1)
        m = masks.view(np.int32)[:, None, :]
        gather = lambda p: torch.from_numpy(p.view(np.int32)[safe] & m)
        col = lambda c: torch.from_numpy(shard.cols[c][safe].astype(np.int32))
        got = tm.plane_reduce_reference(
            col("flags"), col("ac"), col("an"), col("rec_id"),
            gather(shard.gt_bits), gather(shard.gt_bits2),
            gather(shard.tok_bits1), gather(shard.tok_bits2),
            torch.from_numpy(valid), has_counts=with_counts)
        np.testing.assert_array_equal(
            got["or_words"].numpy().view(np.uint32), res.or_words)
        if with_counts:
            np.testing.assert_array_equal(got["pc_call"].numpy()[valid],
                                          res.pc_call[valid])
            np.testing.assert_array_equal(got["pc_tok"].numpy()[valid],
                                          res.pc_tok[valid])
        assert valid.any() and res.or_words.any()


# -- sharded_selected_query (J7, selected) -------------------------------------


def _masks(kind, d_pad, W, n_samples, seed=0):
    g = np.random.default_rng(seed)
    if kind == "ones":
        return np.full((d_pad, W), 0xFFFFFFFF, np.uint32)
    if kind == "empty":
        return np.zeros((d_pad, W), np.uint32)
    out = np.zeros((d_pad, W), np.uint32)
    for d in range(d_pad):
        sel = g.choice(n_samples, g.integers(1, n_samples + 1), replace=False)
        out[d] = sample_mask_words(sel.tolist(), W)
    return out


@pytest.mark.parametrize("n_mesh", [1, 2, 8])
@pytest.mark.parametrize("has_counts", [True, False])
@pytest.mark.parametrize("mask_kind", ["ones", "sparse", "empty"])
def test_sharded_selected_query_matches_jax(pshards, jmesh, n_mesh,
                                            has_counts, mask_kind):
    jstack = jm.StackedIndex(pshards, n_datasets_padded=D_PAD,
                             with_planes=True)
    masks = _masks(mask_kind, D_PAD, jstack.plane_words, 7)
    jspecs = _point_specs(JQuerySpec, pshards[0], 10, seed=99)
    jspecs.append(JQuerySpec("7", 1, 1 << 30, 1, 1 << 30,
                             alternate_bases="N"))  # overflows
    want = jm.sharded_selected_query(
        jstack.shard_to_mesh(jmesh), jspecs, masks, mesh=jmesh,
        n_iters=jstack.n_iters, window_cap=2048, record_cap=32,
        has_counts=has_counts)
    tstack = tm.StackedIndex(_port(pshards), n_datasets_padded=D_PAD,
                             with_planes=True)
    mesh = _tmesh(n_mesh)
    tspecs = [QuerySpec(**dataclasses.asdict(s)) for s in jspecs]
    got = tm.sharded_selected_query(
        tstack.shard_to_mesh(mesh), tspecs, masks, mesh=mesh,
        n_iters=tstack.n_iters, window_cap=2048, record_cap=32,
        has_counts=has_counts)
    _assert_leaves(got[0], want[0])
    _assert_leaves(got[1], want[1])
    assert got[1]["n_overflow"][-1] > 0


def _selected_payload(ds, spec, names):
    return VariantQueryPayload(
        dataset_ids=[ds], reference_name=spec.chrom,
        start_min=spec.start_min, start_max=spec.start_max, end_min=1,
        end_max=1 << 30, alternate_bases="N", requested_granularity="record",
        include_datasets="HIT", include_samples=True,
        selected_samples_only=True, sample_names={ds: names},
    )


@pytest.mark.parametrize("n_mesh", [1, 8])
def test_sharded_selected_query_planes(pshards, n_mesh):
    """Selected call/allele counts and sample-hit unions equal the
    per-dataset materialisation (mirrors test_mesh_serving.py's
    test_sharded_selected_query_planes; the datasets without ploidy > 2
    rows, whose host extras the device counts leave out)."""
    shards = _port(pshards[1:])
    names = [f"S{i}" for i in range(7)]
    stack = tm.StackedIndex(shards, n_datasets_padded=D_PAD,
                            with_planes=True)
    assert stack.has_planes and stack.has_count_planes
    mesh = _tmesh(n_mesh)
    selected = [0, 2, 6]
    masks = np.tile(sample_mask_words(selected, stack.plane_words),
                    (D_PAD, 1))
    assert not any(len(s.gt_overflow) for s in shards)
    specs = _point_specs(QuerySpec, shards[0], 12, seed=99)
    per, agg = tm.sharded_selected_query(
        stack.shard_to_mesh(mesh), specs, masks, mesh=mesh,
        n_iters=stack.n_iters, has_counts=True)
    assert int(agg["n_overflow"].sum()) == 0
    for qi, spec in enumerate(specs):
        want_call = want_all = 0
        for di, shard in enumerate(shards):
            rows = host_match_rows(shard, spec, ref_wildcard=True)
            ds = shard.meta["dataset_id"]
            resp = materialize_response(
                shard, rows,
                _selected_payload(ds, spec, [names[i] for i in selected]),
                chrom_label="7", dataset_id=ds, selected_idx=selected)
            want_call += resp.call_count
            want_all += resp.all_alleles_count
            bits = np.unpackbits(
                per["or_words"][di, qi].view(np.uint32).view(np.uint8),
                bitorder="little").astype(bool)
            assert [k for k, si in enumerate(selected) if bits[si]] == (
                resp.sample_indices), (qi, di)
        assert int(agg["call_count"][qi]) == want_call, qi
        assert int(agg["all_alleles_count"][qi]) == want_all, qi


@pytest.mark.parametrize("n_mesh", [1, 2])
def test_sharded_selected_query_or_sel_edges(n_mesh):
    """(a) a query whose only matches are the dataset's first record
    still reports its sample hits (padding lanes alias rec_id[0]); (b)
    an INFO row with ac=0 but set gt bits in a record before the first
    hit stays out of the sample union (mirrors test_mesh_serving.py)."""
    names = ["S0", "S1", "S2"]
    recs = [
        VcfRecord("1", 100, "A", ["T"], ac=[2], an=6, vt="SNP",
                  genotypes=["0|0", "1|1", "0|0"]),
        VcfRecord("1", 200, "C", ["G"], ac=[0], an=6, vt="SNP",
                  genotypes=["0|0", "0|0", "0|1"]),
        VcfRecord("1", 300, "G", ["A"], ac=[1], an=6, vt="SNP",
                  genotypes=["1|0", "0|0", "0|0"]),
    ]
    shard = shard_from_reference(j_build_index(
        recs, dataset_id="edge", vcf_location="v", sample_names=names))
    stack = tm.StackedIndex([shard], n_datasets_padded=2, pad_unit=1024,
                            with_planes=True)
    mesh = _tmesh(n_mesh)
    selected = [0, 1, 2]
    masks = np.tile(sample_mask_words(selected, stack.plane_words), (2, 1))
    specs = [QuerySpec("1", 100, 100, 1, 1 << 30, alternate_bases="N"),
             QuerySpec("1", 150, 350, 1, 1 << 30, alternate_bases="N")]
    per, agg = tm.sharded_selected_query(
        stack.shard_to_mesh(mesh), specs, masks, mesh=mesh,
        n_iters=stack.n_iters, has_counts=stack.has_count_planes)
    for qi, spec in enumerate(specs):
        rows = host_match_rows(shard, spec, ref_wildcard=True)
        resp = materialize_response(
            shard, rows, _selected_payload("edge", spec, names),
            chrom_label="1", dataset_id="edge", selected_idx=selected)
        bits = np.unpackbits(per["or_words"][0, qi].view(np.uint32).view(
            np.uint8), bitorder="little").astype(bool)
        assert [k for k, si in enumerate(selected) if bits[si]] == (
            resp.sample_indices), qi
        assert int(agg["call_count"][qi]) == resp.call_count, qi
    assert per["or_words"][0, 0].any()
    bits1 = per["or_words"][0, 1].view(np.uint32)[0]
    assert bits1 & 1 and not bits1 & 4  # S0 in, S2 (before k0) out


def test_sharded_selected_query_refuses_missing_planes(qshards, pshards):
    stack = tm.StackedIndex(_port(qshards), n_datasets_padded=4)
    mesh = _tmesh(2)
    with pytest.raises(ValueError, match="without planes"):
        tm.sharded_selected_query(stack.shard_to_mesh(mesh),
                                  _specs(QuerySpec)[:1],
                                  np.zeros((4, 1), np.uint32), mesh=mesh,
                                  n_iters=stack.n_iters)
    gt_only = [dataclasses.replace(s, gt_bits2=None, tok_bits1=None,
                                   tok_bits2=None) for s in _port(pshards)]
    stack = tm.StackedIndex(gt_only, n_datasets_padded=6, with_planes=True)
    with pytest.raises(ValueError, match="count planes"):
        tm.sharded_selected_query(
            stack.shard_to_mesh(mesh), _specs(QuerySpec)[:1],
            np.zeros((6, stack.plane_words), np.uint32), mesh=mesh,
            n_iters=stack.n_iters, has_counts=True)


def test_wrappers_refuse_other_devices(qshards):
    stack = tm.StackedIndex(_port(qshards), n_datasets_padded=3)
    (blk,) = stack.shard_to_mesh(_tmesh(1))
    meta = torch.empty((3, 11, stack.n_padded), dtype=torch.int32,
                       device="meta")
    q = torch.zeros((1, 24), dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tm.stacked_query(meta, blk.alt_prefix, blk.offsets, q,
                         window_cap=64, record_cap=8, n_iters=1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tm.stacked_selected(meta, blk.alt_prefix, blk.offsets, *(q,) * 4,
                            q, q, window_cap=64, record_cap=8, n_iters=1,
                            has_counts=False)
