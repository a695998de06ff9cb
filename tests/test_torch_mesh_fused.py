"""The port's mesh-sharded fused index held against the JAX package's.

The JAX side runs ``MeshFusedIndex.run_mesh_queries`` on the suite's
eight forced CPU devices (tests/conftest.py); the port runs
``parallel.mesh.MeshFusedIndex`` on CPU meshes of 1, 2, 3 and 8 entries
(``make_mesh(devices=[cpu] * n)``), which gives uneven groups and empty
trailing groups, and where the owner-sliced fused query's wrapper runs
its plain-PyTorch twin and the ring gather its sum. The same seeded
shards (built by the JAX package, handed to the port by
``shard_from_reference``) and queries go through both; every output is
an integer or a bool: the tolerance is 0. The CUDA kernels themselves
are held against the twins on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from sbeacon_tpu.genomics.vcf import VcfRecord
from sbeacon_tpu.index.columnar import build_index as j_build_index
from sbeacon_tpu.ops.kernel import QuerySpec as JQuerySpec
from sbeacon_tpu.ops.kernel import encode_queries as j_encode_queries
from sbeacon_tpu.parallel import mesh as jm
from sbeacon_tpu.testing import random_records as j_random_records
from sbeacon_tpu_torch import ops as t_ops
from sbeacon_tpu_torch import telemetry
from sbeacon_tpu_torch.index import shard_from_reference
from sbeacon_tpu_torch.ops.kernel import (
    DeviceIndex,
    QuerySpec,
    encode_queries,
    pack_queries,
    run_queries,
)
from sbeacon_tpu_torch.ops.plane_kernel import sample_mask_words
from sbeacon_tpu_torch.parallel import mesh as tm

CPU = torch.device("cpu")
FIELDS = ("exists", "call_count", "n_variants", "all_alleles_count",
          "n_matched", "overflow", "rows")
PLANE_FIELDS = ("pc_call", "pc_tok", "or_words")
LAYOUTS = {
    "owner": tm.LAYOUT_OWNER,
    "sliced": tm.LAYOUT_SLICED,
    "replicated": tm.LAYOUT_REPLICATED,
}


def _tmesh(n):
    return tm.make_mesh(devices=[CPU] * n)


def _shards(n=4, chrom="1", rows=250, seed0=40, n_samples=2):
    """test_mesh_dispatch.py's corpus."""
    out = []
    for d in range(n):
        rng = random.Random(seed0 + d)
        recs = j_random_records(rng, chrom=chrom, n=rows, n_samples=n_samples)
        out.append(j_build_index(
            recs, dataset_id=f"d{d}", vcf_location=f"v{d}",
            sample_names=[f"S{i}" for i in range(n_samples)],
        ))
    return out


def _count_shards(n=5, *, derived=True, widths=None):
    """Plane corpora of seven samples (or ``widths`` samples per
    dataset): genotype-derived counts with ploidy > 2 rows and 12-alt
    records in dataset 0, or INFO counts and the gt plane alone (no
    count planes) when ``derived`` is off."""
    out = []
    for d in range(n):
        ns = widths[d] if widths else 7
        names = [f"S{i}" for i in range(ns)]
        rng = random.Random(700 + d)
        recs = j_random_records(rng, chrom="7", n=250, n_samples=ns,
                                p_no_acan=0.5 if derived else 0.0)
        if d == 0 and derived:
            for rec in recs[::11]:
                rec.genotypes[rng.randrange(ns)] = "1|1|1"
                rec.ac = rec.an = None
            for i in range(6):
                recs.append(VcfRecord(
                    chrom="7", pos=recs[-1].pos + 5, ref="AC",
                    alts=[b * k for k in (1, 2, 3) for b in "ACGT"],
                    vt="N/A", ac=None if i % 2 else [1] * 12,
                    an=None if i % 2 else 2 * ns,
                    genotypes=[f"{rng.randint(0, 12)}/{rng.randint(0, 12)}"
                               for _ in names],
                ))
        shard = j_build_index(recs, dataset_id=f"p{d}",
                              vcf_location=f"v{d}", sample_names=names)
        if not derived:
            shard = dataclasses.replace(shard, gt_bits2=None,
                                        tok_bits1=None, tok_bits2=None)
        out.append(shard)
    return out


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return jm.make_mesh(8)


@pytest.fixture(scope="module")
def five():
    return _shards(5, chrom="7")


@pytest.fixture(scope="module")
def derived():
    return _count_shards()


def _port(shards):
    return [shard_from_reference(s) for s in shards]


SPECS7 = [
    ("7", 1, 1 << 30, dict(alternate_bases="N")),
    ("7", 1500, 2500, dict(alternate_bases="N")),
    ("7", 900, 1600, dict(alternate_bases="N")),
    ("7", 1, 1 << 30, dict(variant_type="DEL")),
    ("7", 200, 3000, dict(variant_type="INV")),  # VT_OTHER
    ("7", 1, 1 << 30, dict(alternate_bases="N", reference_bases="A")),
    ("1", 1, 1 << 30, dict(alternate_bases="N")),  # absent chromosome
]


def _pairs(n_shards, specs=SPECS7, skew=False):
    """(specs, shard ids) over every shard, or all on shard 0 (skew)."""
    sids = [0] * n_shards if skew else list(range(n_shards))
    pairs = [(s, sid) for s in specs for sid in sids]
    rng = random.Random(len(pairs))
    rng.shuffle(pairs)
    return pairs


def _enc(cls_spec, enc_fn, pairs):
    return enc_fn([cls_spec(c, a, b, 1, 1 << 30, **kw)
                   for (c, a, b, kw), _ in pairs],
                  shard_ids=[sid for _, sid in pairs])


def _assert_same(got, want, fields=FIELDS, label=""):
    for name in fields:
        g = np.asarray(getattr(got, name))
        w = np.asarray(getattr(want, name))
        if name == "or_words":
            g, w = g.view(np.uint32), w.view(np.uint32)
        assert g.shape == w.shape, (label, name, g.shape, w.shape)
        assert np.array_equal(g, w), (label, name)


_JAX_CACHE: dict = {}


def _jax_run(key, jshards, jmesh, enc, **kw):
    """JAX results, cached per case (each JAX shape compiles once)."""
    if key not in _JAX_CACHE:
        mfi = _JAX_CACHE.setdefault(
            ("index", id(jshards), kw.get("sample_masks") is not None),
            jm.MeshFusedIndex(jshards, jmesh,
                              with_planes=kw.get("sample_masks") is not None),
        )
        _JAX_CACHE[key] = mfi.run_mesh_queries(dict(enc), **kw)
    return _JAX_CACHE[key]


# -- layout and parity ---------------------------------------------------------


@pytest.mark.parametrize("n_mesh", [1, 2, 3, 8])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("caps", [(2048, 64), (256, 16)])
def test_parity_per_pair_with_jax(five, jmesh, n_mesh, layout, skew, caps):
    """Every (shard, query) pair, in every layout and on meshes with
    uneven and empty trailing groups, equals JAX's answer byte for
    byte, rows dataset-local."""
    pairs = _pairs(5, skew=skew)
    kw = dict(window_cap=caps[0], record_cap=caps[1])
    want = _jax_run(("five", skew, caps), five, jmesh,
                    _enc(JQuerySpec, j_encode_queries, pairs), **kw)
    mfi = tm.MeshFusedIndex(_port(five), _tmesh(n_mesh),
                            layout=LAYOUTS[layout])
    got = mfi.run_mesh_queries(_enc(QuerySpec, encode_queries, pairs), **kw)
    _assert_same(got, want, label=(n_mesh, layout))
    assert got.pc_call is None and got.or_words is None


@pytest.mark.parametrize("n_mesh", [2, 3])
def test_parity_with_single_shard_kernel(five, n_mesh):
    """The fused answer of a pair equals the single-shard index's."""
    shards = _port(five)
    mfi = tm.MeshFusedIndex(shards, _tmesh(n_mesh))
    pairs = _pairs(5)
    res = mfi.run_mesh_queries(_enc(QuerySpec, encode_queries, pairs),
                               window_cap=2048, record_cap=64)
    for i, ((c, a, b, kw), sid) in enumerate(pairs):
        ref = run_queries(DeviceIndex(shards[sid], CPU),
                          [QuerySpec(c, a, b, 1, 1 << 30, **kw)],
                          window_cap=2048, record_cap=64)
        for name in ("exists", "call_count", "n_matched", "overflow",
                     "all_alleles_count"):
            assert getattr(res, name)[i] == getattr(ref, name)[0], name
        assert np.array_equal(res.rows[i][res.rows[i] >= 0],
                              ref.rows[0][ref.rows[0] >= 0])


def _masks(kind, b, w, n_samples, seed):
    """uint32 [b, w] sample masks: all ones, empty, or about a quarter of
    the real samples' bits set."""
    if kind == "ones":
        return np.full((b, w), 0xFFFFFFFF, np.uint32)
    if kind == "empty":
        return np.zeros((b, w), np.uint32)
    rng = np.random.default_rng(seed)
    words = lambda: rng.integers(0, 2**32, size=(b, w), dtype=np.uint64)
    real = sample_mask_words(range(n_samples), w)
    return (words() & words()).astype(np.uint32) & real


@pytest.mark.parametrize("n_mesh", [1, 2, 3, 8])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mask_kind", ["ones", "sparse", "empty"])
@pytest.mark.parametrize("counts", ["on", "off", "mixed"])
def test_plane_parity_with_jax(derived, jmesh, n_mesh, layout, mask_kind,
                               counts):
    """The plane program (per-query masks, restricted counting both
    ways) in every layout equals JAX's, pc_call / pc_tok / or_words
    included."""
    pairs = _pairs(5, SPECS7[:3] + SPECS7[5:6])
    b = len(pairs)
    w = max(s.gt_bits.shape[1] for s in derived)
    masks = _masks(mask_kind, b, w, 7, seed=b)
    mc = {"on": np.ones(b, np.bool_), "off": np.zeros(b, np.bool_),
          "mixed": np.arange(b) % 2 == 0}[counts]
    kw = dict(window_cap=2048, record_cap=48, sample_masks=masks,
              mask_counts=mc)
    want = _jax_run(("derived", mask_kind, counts), derived, jmesh,
                    _enc(JQuerySpec, j_encode_queries, pairs), **kw)
    mfi = tm.MeshFusedIndex(_port(derived), _tmesh(n_mesh), with_planes=True,
                            layout=LAYOUTS[layout])
    assert mfi.has_count_planes
    got = mfi.run_mesh_queries(_enc(QuerySpec, encode_queries, pairs), **kw)
    _assert_same(got, want, FIELDS + PLANE_FIELDS, label=(n_mesh, layout))
    assert got.or_words.shape == (b, w)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_plane_parity_without_count_planes(jmesh, layout):
    """A stack whose shards lack count planes forces restricted counting
    off, as JAX does (mask_counts on is ignored)."""
    jshards = _count_shards(4, derived=False)
    pairs = _pairs(4, SPECS7[:2])
    b = len(pairs)
    w = jshards[0].gt_bits.shape[1]
    kw = dict(window_cap=2048, record_cap=64,
              sample_masks=_masks("sparse", b, w, 7, seed=3),
              mask_counts=np.ones(b, np.bool_))
    want = _jax_run(("info",), jshards, jmesh,
                    _enc(JQuerySpec, j_encode_queries, pairs), **kw)
    mfi = tm.MeshFusedIndex(_port(jshards), _tmesh(3), with_planes=True,
                            layout=LAYOUTS[layout])
    assert mfi.has_planes and not mfi.has_count_planes
    got = mfi.run_mesh_queries(_enc(QuerySpec, encode_queries, pairs), **kw)
    _assert_same(got, want, FIELDS + PLANE_FIELDS, label=layout)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_heterogeneous_sample_widths(jmesh, layout):
    """Shards of 3, 40 and 70 samples (1, 2 and 3 plane words): the
    stack's W is the widest, and or_words equal JAX's stack-wide words."""
    jshards = _count_shards(3, widths=[3, 40, 70])
    pairs = _pairs(3, SPECS7[:2])
    b = len(pairs)
    kw = dict(window_cap=2048, record_cap=64,
              sample_masks=_masks("ones", b, 3, 70, seed=1),
              mask_counts=np.arange(b) % 2 == 1)
    want = _jax_run(("widths",), jshards, jmesh,
                    _enc(JQuerySpec, j_encode_queries, pairs), **kw)
    mfi = tm.MeshFusedIndex(_port(jshards), _tmesh(2), with_planes=True,
                            layout=LAYOUTS[layout])
    assert mfi.plane_words == 3
    got = mfi.run_mesh_queries(_enc(QuerySpec, encode_queries, pairs), **kw)
    _assert_same(got, want, FIELDS + PLANE_FIELDS, label=layout)


def test_layouts_byte_identical(derived):
    """The three layouts answer byte-identically, with and without
    planes, on a mesh with an empty trailing group."""
    mfi = tm.MeshFusedIndex(_port(derived), _tmesh(8), with_planes=True)
    pairs = _pairs(5, SPECS7[:3])
    b = len(pairs)
    masks = _masks("sparse", b, mfi.plane_words, 7, seed=5)
    for planes in (False, True):
        kw = dict(window_cap=2048, record_cap=32)
        if planes:
            kw.update(sample_masks=masks, mask_counts=np.arange(b) % 3 == 0)
        runs = []
        for layout in LAYOUTS.values():
            mfi.layout = layout
            runs.append(mfi.run_mesh_queries(
                _enc(QuerySpec, encode_queries, pairs), **kw))
        for other in runs[1:]:
            _assert_same(other, runs[0],
                         FIELDS + (PLANE_FIELDS if planes else ()))


# -- the block layout ----------------------------------------------------------


@pytest.mark.parametrize("n_mesh", [1, 2, 3, 8])
def test_group_blocks(five, n_mesh):
    """Entry g holds shards [g * d_local, (g + 1) * d_local) padded to the
    common row count; empty trailing groups have zero segment rows."""
    shards = _port(five)
    mfi = tm.MeshFusedIndex(shards, _tmesh(n_mesh))
    dl = -(-5 // n_mesh)
    assert mfi.d_local == dl and len(mfi.blocks) == n_mesh
    n_pad = mfi.n_padded
    for g, blk in enumerate(mfi.blocks):
        grp = shards[g * dl : (g + 1) * dl]
        assert tuple(blk.columns.shape) == (11, n_pad)
        assert tuple(blk.offsets.shape) == (dl, 27)
        base = 0
        for k, s in enumerate(grp):
            assert int(blk.seg_base[k]) == base
            assert np.array_equal(blk.offsets[k].numpy(),
                                  s.chrom_offsets + base)
            base += s.n_rows
        assert not blk.offsets[len(grp):].any()
    assert mfi.window_hint == tm.window_hint_for(mfi.chrom_offsets)


def test_slice_layout_fillers_on_empty_groups(five):
    """Filler slots carry chrom 0 aimed at their entry's first local
    shard, past n_shards on an empty trailing group; their outputs are
    inert in every layout."""
    mfi = tm.MeshFusedIndex(_port(five), _tmesh(8))
    pairs = _pairs(5, SPECS7[:1], skew=True) + [(SPECS7[0], 4)]
    enc = _enc(QuerySpec, encode_queries, pairs)
    out, _m, _u, pos, counts, c_slot = mfi._slice_layout(enc, None, None)
    assert c_slot == 5 and list(counts) == [5, 0, 0, 0, 1, 0, 0, 0]
    fill = np.setdiff1d(np.arange(8 * c_slot), pos)
    assert (out["chrom"][fill] == 0).all()
    assert np.array_equal(out["shard"][fill] // mfi.d_local,
                          fill // c_slot)
    assert out["shard"].max() == 7 > mfi.n_shards
    q = torch.from_numpy(pack_queries(out, fused=True))
    for g in (5, 7):  # empty trailing groups: every slot a filler
        blk = mfi.blocks[g]
        for layout in (tm.LAYOUT_OWNER, tm.LAYOUT_SLICED):
            res, _seq = tm.mesh_fused(
                blk.columns, blk.alt_prefix, blk.offsets, blk.seg_base,
                q[g * c_slot : (g + 1) * c_slot], me=g, d_local=mfi.d_local,
                n_dev=8, C=c_slot, layout=layout, window_cap=2048,
                record_cap=64, n_iters=mfi.n_iters)
            assert not res["agg"].any()
            pad = 0 if layout == tm.LAYOUT_SLICED else -1
            assert (res["rows"] == pad).all()


def test_owner_fetch_holds_c_slot_slots(five):
    """The owner-sharded fetch reads each entry's first counts[g] slots
    of its own c_slot-slot outputs, fetching fewer bytes than the
    combined layout; an entry holding more than c_slot slots trips the
    fetch's assertion."""
    mfi = tm.MeshFusedIndex(_port(five), _tmesh(4))
    pairs = _pairs(5, SPECS7[:2], skew=True)
    fetched = {}
    for name in ("owner", "sliced"):
        telemetry.reset_launch_counts()
        mfi.layout = LAYOUTS[name]
        mfi.run_mesh_queries(_enc(QuerySpec, encode_queries, pairs),
                             window_cap=2048, record_cap=64)
        fetched[name] = telemetry.total("mesh_fetch_bytes")
    assert fetched["owner"] < fetched["sliced"]
    full = {"agg": torch.zeros((8, 5), dtype=torch.int32),
            "rows": torch.zeros((8, 4), dtype=torch.int32)}
    pending = tm.MeshPendingResults(
        [full, full], 3, np.array([0, 1, 4]), owner_layout=(2, 4, [2, 1]))
    with pytest.raises(AssertionError, match="want 4"):
        pending.fetch()


def test_evaluated_pairs_sliced_at_most_half_replicated(five):
    mfi = tm.MeshFusedIndex(_port(five), _tmesh(8))
    pairs = _pairs(5, SPECS7[:3])
    counted = {}
    for name in ("sliced", "replicated"):
        p0 = tm.N_EVALUATED_PAIRS
        mfi.layout = LAYOUTS[name]
        mfi.run_mesh_queries(_enc(QuerySpec, encode_queries, pairs),
                             window_cap=2048, record_cap=64)
        counted[name] = tm.N_EVALUATED_PAIRS - p0
    assert counted["sliced"] * 2 <= counted["replicated"], counted
    assert counted["replicated"] == len(pairs) * 8


def test_defaults_chain(five, monkeypatch):
    """The layout is the index's one argument (owner by default, no
    environment default: BEACON_MESH_SLICE / BEACON_MESH_OWNER_OUTPUTS
    are ignored); a one-entry mesh takes the replicated layout; each
    run_mesh_queries call counts one mesh program."""
    pairs = _pairs(5, SPECS7[:1])
    seen = []
    real = tm.mesh_fused

    def spy(*a, **kw):
        seen.append(kw["layout"])
        return real(*a, **kw)

    monkeypatch.setattr(tm, "mesh_fused", spy)

    def layout_of(mfi):
        seen.clear()
        n0 = tm.N_LAUNCHES
        mfi.run_mesh_queries(_enc(QuerySpec, encode_queries, pairs),
                             window_cap=2048, record_cap=8)
        assert tm.N_LAUNCHES == n0 + 1
        assert len(set(seen)) == 1 and len(seen) == mfi.n_dev
        return seen[0]

    monkeypatch.setenv("BEACON_MESH_OWNER_OUTPUTS", "off")
    monkeypatch.setenv("BEACON_MESH_SLICE", "0")
    mfi = tm.MeshFusedIndex(_port(five), _tmesh(2))
    assert mfi.layout == tm.LAYOUT_OWNER
    for layout in LAYOUTS.values():
        mfi.layout = layout
        assert layout_of(mfi) == layout
    one = tm.MeshFusedIndex(_port(five), _tmesh(1))
    assert layout_of(one) == tm.LAYOUT_REPLICATED
    with pytest.raises(ValueError, match="unknown layout"):
        tm.MeshFusedIndex(_port(five), _tmesh(2), layout=3)


# -- loud errors ---------------------------------------------------------------


def test_errors_match_jax(five, jmesh):
    """The same loud errors as JAX for a bare list, missing shard ids
    and masks on a plane-less stack."""
    jmfi = jm.MeshFusedIndex(five, jmesh)
    mfi = tm.MeshFusedIndex(_port(five), _tmesh(2))
    cases = [
        ([QuerySpec("7", 1, 10, 1, 20)], {}, "explicit shard ids"),
        ({"chrom": np.zeros(1, np.int32)}, {}, "carry shard ids"),
        (encode_queries([QuerySpec("7", 1, 10, 1, 20)], shard_ids=[0]),
         {"sample_masks": np.zeros((1, 1), np.uint32)}, "no genotype planes"),
    ]
    jcases = [
        [JQuerySpec("7", 1, 10, 1, 20)],
        {"chrom": np.zeros(1, np.int32)},
        j_encode_queries([JQuerySpec("7", 1, 10, 1, 20)], shard_ids=[0]),
    ]
    for (q, kw, match), jq in zip(cases, jcases):
        with pytest.raises(ValueError, match=match) as got:
            mfi.run_mesh_queries(q, window_cap=2048, record_cap=64, **kw)
        with pytest.raises(ValueError) as want:
            jmfi.run_mesh_queries(jq, window_cap=2048, record_cap=64, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="at least one shard"):
        tm.MeshFusedIndex([], _tmesh(2))


def test_run_queries_auto_dispatches_the_mesh_index(five):
    shards = _port(five)
    mfi = tm.MeshFusedIndex(shards, _tmesh(2))
    pairs = _pairs(5, SPECS7[:2])
    enc = _enc(QuerySpec, encode_queries, pairs)
    got = t_ops.run_queries_auto(mfi, dict(enc), window_cap=2048,
                                 record_cap=64)
    want = mfi.run_mesh_queries(dict(enc), window_cap=2048, record_cap=64)
    _assert_same(got, want)
    masks = np.zeros((1, 1), np.uint32)
    for index in (DeviceIndex(shards[0], CPU),
                  t_ops.make_device_index(shards[0], CPU)):
        with pytest.raises(ValueError, match="mesh plane program"):
            t_ops.run_queries_auto(index, [QuerySpec("7", 1, 9, 1, 9)],
                                   sample_masks=masks)


def test_plane_bytes_per_device_counts_real_words(derived):
    shards = _port(derived)
    got = tm.MeshFusedIndex.plane_bytes_per_device(shards, n_dev=2)
    n_pad = tm.padded_rows(sum(s.n_rows for s in shards[:3]),
                           tm.MeshFusedIndex.PAD_UNIT)
    assert got == n_pad * shards[0].gt_bits.shape[1] * 4 * 4
    mfi = tm.MeshFusedIndex(shards, _tmesh(2), with_planes=True)
    assert mfi.plane_bytes_device == got
    assert all(len(b.planes) == 4 and b.planes[0].shape == (n_pad, 1)
               for b in mfi.blocks)
    assert tm.MeshFusedIndex(shards, _tmesh(2)).plane_bytes_device == 0
