"""The CUDA kernels (scatter match, bisection query, fused match +
planes, plane stats, distinct count, stacked query, stacked selected,
owner-sliced fused query, ring gather) against their plain-PyTorch
twins, the mesh launch and the pod tier on the card against the CPU,
and the device time probes on CUDA events. Where a wrapper's outputs
must all be written by its launch, its buffers come pre-filled with
0xDEADBEEF; a ``torch.profiler`` trace shows which kernels a call ran.

Runs only where a CUDA device is present (marker ``cuda``); elsewhere
every test skips. It imports nothing of the JAX package, so it runs on
a GPU host without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Outputs are integers: kernel and twin must be equal (tolerance 0).
"""

import random
import time

import numpy as np
import pytest
import torch

from sbeacon_tpu_torch import telemetry
from sbeacon_tpu_torch.config import BeaconConfig, EngineConfig
from sbeacon_tpu_torch.engine import VariantEngine
from sbeacon_tpu_torch.genomics.vcf import VcfRecord
from sbeacon_tpu_torch.index import build_index
from sbeacon_tpu_torch.ops import kernel as tk
from sbeacon_tpu_torch.ops import plane_kernel as pk
from sbeacon_tpu_torch.ops import scatter_kernel as sk
from sbeacon_tpu_torch.ops import timing
from sbeacon_tpu_torch.payloads import VariantQueryPayload
from sbeacon_tpu_torch.ops.kernel import QuerySpec, encode_queries
from sbeacon_tpu_torch.ops.query_pack import pack_q8, window_bounds
from sbeacon_tpu_torch.parallel import distinct as dc
from sbeacon_tpu_torch.parallel import mesh as tm
from sbeacon_tpu_torch.testing import (
    distinct_key_cases,
    l0_tail_keys,
    l0_tail_specs,
    random_records,
    subset_shard,
    synthetic_shard,
    window_edge_shards,
    window_edge_specs,
)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def index(cuda_device):
    rng = random.Random(7)
    recs = random_records(
        rng, chrom="1", n=2000, n_samples=0, spacing=10, p_symbolic=0.15,
        p_multiallelic=0.3,
    )
    return sk.ScatterDeviceIndex(build_index(recs, dataset_id="c"), cuda_device)


def _inputs(index, n, width, exact, seed):
    rng = random.Random(seed)
    shard = index.shard
    pos = shard.cols["pos"]
    specs = []
    for _ in range(n):
        i = rng.randrange(shard.n_rows - width)
        kw = dict(chrom="1", start_min=int(pos[i]),
                  start_max=int(pos[i + rng.randint(0, width)]),
                  end_min=1, end_max=1 << 30)
        if exact:
            kw.update(alternate_bases=shard.row_alt(i))
        else:
            kw.update(rng.choice([
                {"alternate_bases": "N"},
                {"variant_type": rng.choice(["DEL", "INS", "DUP", "CNV"])},
            ]))
        specs.append(QuerySpec(**kw))
    enc = encode_queries(specs)
    lo, hi = window_bounds(index, enc)
    q8, _ = pack_q8(enc, lo, hi)
    dev = index.device
    return (
        torch.from_numpy((lo // index.tile).astype(np.int32)).to(dev),
        torch.from_numpy(q8).to(dev),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("exact_only", [True, False])
@pytest.mark.parametrize("C,cap,width", [(1, 128, 0), (2, 128, 100),
                                         (5, 512, 400), (17, 2048, 1500)])
def test_kernel_matches_twin(index, C, cap, width, exact_only):
    ids, q8 = _inputs(index, 300, width, exact_only, seed=C)
    agg, masks, seq = sk.scatter_match(
        index.tiles, ids, q8, T=index.tile, CAP=cap, C=C,
        exact_only=exact_only,
    )
    torch.cuda.synchronize()
    assert seq is not None
    assert int(agg[:, 4].sum()) > 0
    for seg_k in (index.seg_k, None):
        want_agg, want_masks = sk.scatter_core_reference(
            index.tiles, ids, q8, T=index.tile, CAP=cap, C=C,
            exact_only=exact_only, seg_k=seg_k,
        )
        assert torch.equal(agg, want_agg)
        assert torch.equal(masks, want_masks)


def _main_path_slots(index, n_real, width, exact, seed):
    """(tile_ids, q8) as _launch_tier pads n_real queries: to 64 slots
    (CHUNK_SMALL) with q8 all zeros and tile 0 in the pad slots; numpy."""
    ids, q8 = _inputs(index, n_real, width, exact, seed)
    ids, q8 = ids.cpu().numpy(), q8.cpu().numpy()
    pad = sk.CHUNK_SMALL - n_real
    return (np.concatenate([ids, np.zeros(pad, np.int32)]),
            np.concatenate([q8, np.zeros((pad, 8), np.int32)]))


@pytest.mark.cuda
@pytest.mark.parametrize("exact_only", [True, False])
@pytest.mark.parametrize("C,cap,width", [(1, 128, 0), (2, 128, 100),
                                         (5, 512, 400), (17, 2048, 1500)])
@pytest.mark.parametrize("n_real", [1, 6, 15, 64])
def test_kernel_main_path_shape(index, C, cap, width, exact_only, n_real,
                                monkeypatch):
    """The launch the main path makes: _launch_tier with n_real queries
    padded to 64 slots (the pad slots' windows are empty, so the kernel
    reads no tile for them), on 0xDEADBEEF-filled outputs: every word is
    written and equals the twin's."""
    ids, q8 = _main_path_slots(index, n_real, width, exact_only, 31 + C)
    t = lambda x: torch.from_numpy(x).to(index.device)
    wants = [sk.scatter_core_reference(
        index.tiles, t(ids), t(q8), T=index.tile, CAP=cap, C=C,
        exact_only=exact_only, seg_k=seg_k) for seg_k in (index.seg_k, None)]
    _deadbeef_empty(monkeypatch)
    agg, masks, seq = sk._launch_tier(index, ids, q8, cap=cap, C=C,
                                      exact_only=exact_only)
    torch.cuda.synchronize()
    assert seq is not None and agg.shape[0] == sk.CHUNK_SMALL
    assert n_real == 1 or int(agg[:, 4].sum()) > 0
    assert not agg[n_real:].any() and not masks[n_real:].any()
    for want_agg, want_masks in wants:
        assert torch.equal(agg, want_agg)
        assert torch.equal(masks, want_masks)


def _long_record_index(device):
    """A shard of 40-alt records (40 rows each, SAME_PREV chains longer
    than a 32-lane group) packed back to back across tile boundaries,
    with single-alt records between some of them."""
    import itertools

    alts = ["".join(p) for k in (1, 2) for p in itertools.product("ACGT",
                                                                  repeat=k)]
    alts = (alts + [a + "A" for a in alts])[:40]
    recs = []
    for i in range(60):
        recs.append(VcfRecord(
            chrom="1", pos=1000 + 10 * i, ref="G", alts=alts, vt="N/A",
            ac=[(i + j) % 3 for j in range(40)], an=20 + i, genotypes=[]))
        if i % 3 == 0:
            recs.append(VcfRecord(chrom="1", pos=1005 + 10 * i, ref="A",
                                  alts=["T"], vt="SNP", ac=[1], an=7,
                                  genotypes=[]))
    return sk.ScatterDeviceIndex(build_index(recs, dataset_id="long"), device)


@pytest.mark.cuda
@pytest.mark.parametrize("exact_only", [True, False])
def test_kernel_c17_records_across_tiles(cuda_device, exact_only):
    """J1 at C = 17 on records whose SAME_PREV chains cross 32-lane
    groups and tile boundaries, windows starting at every record and
    ending anywhere: equal to both twin forms."""
    index = _long_record_index(cuda_device)
    shard = index.shard
    pos = shard.cols["pos"]
    starts = np.flatnonzero(np.diff(np.concatenate([[-1], pos])) != 0)
    rng = random.Random(3)
    specs = []
    for i in starts:
        last = min(int(i) + rng.randint(0, 1900), shard.n_rows - 1)
        kw = dict(chrom="1", start_min=int(pos[i]), start_max=int(pos[last]),
                  end_min=1, end_max=1 << 30)
        if exact_only:
            kw.update(alternate_bases=shard.row_alt(int(i) + rng.randrange(
                min(40, shard.n_rows - int(i)))))
        else:
            kw.update(rng.choice([{"alternate_bases": "N"},
                                  {"variant_type": "INS"},
                                  {"variant_type": "DEL"}]))
        specs.append(QuerySpec(**kw))
    enc = encode_queries(specs)
    lo, hi = window_bounds(index, enc)
    q8, _ = pack_q8(enc, lo, hi)
    ids = torch.from_numpy((lo // index.tile).astype(np.int32)).to(cuda_device)
    q8 = torch.from_numpy(q8).to(cuda_device)
    agg, masks, _seq = sk.scatter_match(index.tiles, ids, q8, T=index.tile,
                                        CAP=2048, C=17, exact_only=exact_only)
    torch.cuda.synchronize()
    assert int(agg[:, 3].sum()) > 0
    for seg_k in (index.seg_k, None):
        want_agg, want_masks = sk.scatter_core_reference(
            index.tiles, ids, q8, T=index.tile, CAP=2048, C=17,
            exact_only=exact_only, seg_k=seg_k)
        assert torch.equal(agg, want_agg)
        assert torch.equal(masks, want_masks)


@pytest.mark.cuda
def test_scattered_batch_on_card_equals_cpu(index):
    """The whole dispatch on the card (tier split, one launch per
    split, readback and row unpacking) gives the same QueryResults as
    the CPU twin path."""
    rng = random.Random(11)
    shard = index.shard
    pos = shard.cols["pos"]
    specs = []
    for _ in range(200):
        i = rng.randrange(shard.n_rows - 2000)
        kw = dict(chrom="1", start_min=int(pos[i]),
                  start_max=int(pos[i + rng.choice([0, 50, 400, 1500, 1999])]),
                  end_min=1, end_max=1 << 30)
        kw.update(rng.choice([
            {"alternate_bases": shard.row_alt(i)},
            {"alternate_bases": "N"},
            {"variant_type": rng.choice(["DEL", "INS", "DUP", "CNV"])},
        ]))
        specs.append(QuerySpec(**kw))
    cpu = sk.ScatterDeviceIndex(shard, "cpu")
    got = sk.run_queries_scattered(index, specs, window_cap=2048, record_cap=256)
    want = sk.run_queries_scattered(cpu, specs, window_cap=2048, record_cap=256)
    for field in ("exists", "call_count", "n_variants", "all_alleles_count",
                  "n_matched", "overflow", "rows"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def _fused_shards():
    """Three shards: random records with symbolic alts, one with
    12-alt records, other symbolic types and a dense run, and one whose
    chromosome 1 is empty."""
    rng = random.Random(17)
    a = random_records(rng, chrom="1", n=1500, n_samples=0, spacing=10,
                       p_symbolic=0.2, p_multiallelic=0.3)
    for i in range(30):
        a.append(VcfRecord(
            chrom="1", pos=40_000 + 7 * i, ref="AC",
            alts=[b * k for k in (1, 2, 3) for b in "ACGT"], vt="N/A",
            ac=[(i + j) % 4 for j in range(12)], an=40, genotypes=[],
        ))
    for i in range(40):
        a.append(VcfRecord(
            chrom="1", pos=41_000 + 5 * i, ref="G",
            alts=[["<INV>", "<INS:ME:ALU>", "<DUP:TANDEM:EXTRA_LONG>",
                   "<CNV>"][i % 4]],
            vt="SV", ac=[2], an=10, genotypes=[],
        ))
    for i in range(1500):
        a.append(VcfRecord(chrom="1", pos=50_000 + i, ref="A", alts=["T"],
                           vt="SNP", ac=[1], an=2, genotypes=[]))
    b = random_records(rng, chrom="1", n=800, n_samples=0, spacing=25)
    c = random_records(rng, chrom="22", n=600, n_samples=0)
    return [build_index(r, dataset_id=d) for r, d in
            ((a, "fa"), (b, "fb"), (c, "fc"))]


@pytest.fixture(scope="module")
def fused(cuda_device):
    shards = _fused_shards()
    return (tk.FusedDeviceIndex(shards, cuda_device),
            tk.FusedDeviceIndex(shards, "cpu"), shards)


def _fused_specs(shards, n, seed):
    rng = random.Random(seed)
    specs, sids = [], []
    for _ in range(n):
        sid = rng.randrange(len(shards))
        sh = shards[sid]
        i = rng.randrange(sh.n_rows)
        p = int(sh.cols["pos"][i])
        w = rng.choice([0, 0, 50, 500, 3000, 30000])
        kw = dict(chrom=rng.choice([sh.row_chrom(i), "1"]),
                  start_min=max(1, p - w), start_max=p + w,
                  end_min=1, end_max=1 << 30)
        kind = rng.randrange(7)
        if kind == 0:
            kw.update(reference_bases=rng.choice([None, sh.row_ref(i)]),
                      alternate_bases=sh.row_alt(i))
        elif kind == 1:
            kw.update(alternate_bases="N", reference_bases=rng.choice(
                [None, "N", "A"]))
        elif kind == 2:
            kw.update(variant_type=rng.choice(
                ["DEL", "INS", "DUP", "DUP:TANDEM", "CNV"]))
        elif kind == 3:
            kw.update(variant_type=rng.choice(
                ["INV", "INS:ME", "DUP:TANDEM:EXTRA_LONG", "SNP", None]))
        elif kind == 4:
            kw.update(alternate_bases="N", variant_min_length=1,
                      variant_max_length=rng.choice([-1, 2]))
        elif kind == 5:
            kw.update(start_min=1, start_max=2**31 - 1,
                      alternate_bases="N")
        else:
            kw.update(chrom="1", start_min=40_000, start_max=52_000,
                      alternate_bases=rng.choice(["N", "T"]))
        specs.append(QuerySpec(**kw))
        sids.append(sid)
    return specs, sids


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 64, 512])
@pytest.mark.parametrize("window_cap,record_cap", [(2048, 1024), (256, 16),
                                                  (4096, 4096)])
def test_bisect_kernel_matches_twin(fused, b, window_cap, record_cap):
    index, _cpu, shards = fused
    specs, sids = _fused_specs(shards, b, seed=b + window_cap)
    q = torch.from_numpy(tk.pack_queries(
        encode_queries(specs, shard_ids=sids), fused=True)).to(index.device)
    W = min(window_cap, index.window_hint)
    out, seq = tk.bisect_query(
        index.columns, index.alt_prefix, index.offsets, q, window_cap=W,
        record_cap=record_cap, n_iters=index.n_iters,
    )
    torch.cuda.synchronize()
    assert seq is not None
    want = tk.query_batch_reference(
        index.columns, index.alt_prefix, index.offsets, q, window_cap=W,
        record_cap=record_cap, n_iters=index.n_iters,
    )
    assert torch.equal(out, want)
    assert int(out[:, 4].sum()) > 0


@pytest.mark.cuda
def test_fused_batch_on_card_equals_cpu(fused):
    """The whole dispatch on the card gives the CPU twin's results."""
    index, cpu, shards = fused
    specs, sids = _fused_specs(shards, 300, seed=99)
    enc = encode_queries(specs, shard_ids=sids)
    got = tk.run_queries(index, enc, window_cap=2048, record_cap=256)
    want = tk.run_queries(cpu, enc, window_cap=2048, record_cap=256)
    for field in ("exists", "call_count", "n_variants", "all_alleles_count",
                  "n_matched", "overflow", "rows"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert got.overflow.any() and (got.n_matched > 256).any()


@pytest.fixture(scope="module")
def edge_stacks(cuda_device):
    """Fused stacks of 3 and of 11 edge shards (11: past the 9 segment
    rows the kernel loads beside the query row)."""
    return {n: (tk.FusedDeviceIndex(shards, cuda_device), shards)
            for n, shards in ((n, window_edge_shards(n)) for n in (3, 11))}


@pytest.mark.cuda
@pytest.mark.parametrize("W,R", [(2048, 1024), (2048, 1), (2048, 2048),
                                 (700, 257), (257, 255), (256, 16),
                                 (3000, 3000)])
@pytest.mark.parametrize("n_shards", [3, 11])
def test_bisect_kernel_window_edges(edge_stacks, n_shards, W, R,
                                    monkeypatch):
    """Windows of 1-3000 lanes across the 256-lane chunks and the cluster
    ranks, overflow, R below the matches, records of up to 40 rows cut
    at every edge, stacks of 3 and 11 shards, on 0xDEADBEEF-filled
    outputs: equal to the twin."""
    index, shards = edge_stacks[n_shards]
    specs, sids = window_edge_specs(shards, seed=W + R + n_shards)
    q = torch.from_numpy(tk.pack_queries(
        encode_queries(specs, shard_ids=sids), fused=True)).to(index.device)
    kw = dict(window_cap=W, record_cap=R, n_iters=index.n_iters)
    with monkeypatch.context() as mp:
        _deadbeef_empty(mp)
        out, seq = tk.bisect_query(index.columns, index.alt_prefix,
                                   index.offsets, q, **kw)
        torch.cuda.synchronize()
    assert seq is not None
    want = tk.query_batch_reference(index.columns, index.alt_prefix,
                                    index.offsets, q, **kw)
    assert torch.equal(out, want)
    agg = want[:, :tk.N_AGG]
    assert int(agg[:, 5].sum()) > 0
    assert int((agg[:, 4] > R).sum()) > 0 or R == W


#: (keys, shards a key): composites of 1, 4 and 16 keys at 16, 64 and
#: 512 padded shards
L0_SHAPES = ((1, 12), (4, 14), (16, 20))


@pytest.fixture(scope="module")
def l0_composites(cuda_device):
    out = {}
    for n_keys, per_key in L0_SHAPES:
        keys = l0_tail_keys(n_keys, per_key, seed=n_keys, max_records=200)
        blocks = [tk.L0DeviceIndex(s, cuda_device) for s in keys]
        out[n_keys] = (tk.CompositeL0DeviceIndex(blocks), keys)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("W,R", [(256, 1), (256, 60), (512, 16),
                                 (1024, 1024), (2048, 100), (4096, 4096),
                                 (4096, 300)])
@pytest.mark.parametrize("n_keys", [k for k, _ in L0_SHAPES])
def test_bisect_kernel_on_l0_composites(l0_composites, n_keys, W, R,
                                        monkeypatch):
    """The L0 launch: composites of 1, 4 and 16 keys (16, 64 and 512
    padded shards, the segment table read from global memory), windows
    of 256-4096 lanes (clusters of one to eight blocks), record_cap
    below the matches, queries on pad rows, on 0xDEADBEEF-filled
    outputs: equal to the twin, and recorded under ``fused_l0``."""
    index, keys = l0_composites[n_keys]
    assert index.n_shards_padded == {1: 16, 4: 64, 16: 512}[n_keys]
    specs, sids = l0_tail_specs(index, keys, seed=W + R + n_keys)
    q = torch.from_numpy(tk.pack_queries(
        encode_queries(specs, shard_ids=sids), fused=True)).to(index.device)
    kw = dict(window_cap=W, record_cap=R, n_iters=index.n_iters)
    with monkeypatch.context() as mp:
        _deadbeef_empty(mp)
        out, seq = tk.bisect_query(index.columns, index.alt_prefix,
                                   index.offsets, q, family="fused_l0", **kw)
        torch.cuda.synchronize()
    assert telemetry.recent_launches()[-1]["family"] == "fused_l0"
    assert seq is not None
    want = tk.query_batch_reference(index.columns, index.alt_prefix,
                                    index.offsets, q, **kw)
    assert torch.equal(out, want)
    agg = want[:, :tk.N_AGG]
    assert int(agg[:, 4].sum()) > 0
    assert int((agg[:, 4] > R).sum()) > 0 or R >= W


@pytest.mark.cuda
def test_l0_run_queries_on_card_equals_cpu(l0_composites):
    """run_queries on the composite: the launch at the index's
    window_hint, on the card and on CPU copies of the same blocks."""
    index, keys = l0_composites[4]
    cpu = tk.CompositeL0DeviceIndex(
        [tk.L0DeviceIndex(s, torch.device("cpu")) for s in keys])
    specs, sids = l0_tail_specs(index, keys, seed=5)
    enc = encode_queries(specs, shard_ids=sids)
    got = tk.run_queries(index, enc, window_cap=2048, record_cap=1024)
    want = tk.run_queries(cpu, enc, window_cap=2048, record_cap=1024)
    for field in ("exists", "call_count", "n_variants", "all_alleles_count",
                  "n_matched", "overflow", "rows"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


@pytest.mark.cuda
def test_engine_serves_the_delta_tail_through_l0(cuda_device):
    """An engine on the card: a deep tail rides one fused_l0 launch a
    request, its answers equal to a CPU engine's."""
    keys = l0_tail_keys(2, 6, seed=9, max_records=80)
    base = synthetic_shard(3000, seed=9, dataset_id="k0", chroms=["3"])
    engines = [VariantEngine(BeaconConfig(engine=EngineConfig(
        l0_min_shards=3, response_cache=False)), device=d)
        for d in (cuda_device, "cpu")]
    try:
        for eng in engines:
            eng.add_index(base)
            for shards in keys:
                for s in shards:
                    s.meta.pop("delta_epoch", None)
                    eng.add_delta(s)
        telemetry.reset_launch_counts()
        doc = dict(dataset_ids=[], reference_name="3", start_min=1,
                   start_max=1 << 29, end_min=1, end_max=1 << 30,
                   alternate_bases="N", requested_granularity="record",
                   include_datasets="HIT")
        got = engines[0].search(VariantQueryPayload(**doc))
        want = engines[1].search(VariantQueryPayload(**doc))
        assert [r.__dict__ for r in got] == [r.__dict__ for r in want]
        assert telemetry.launches_by_family().get("fused_l0") == 1
    finally:
        for eng in engines:
            eng.close()


N_SAMPLES = 40


def _plane_shard():
    """40 samples (two plane words, a tail word), genotype-derived
    counts on half the records, ploidy > 2 genotypes and 12-alt
    records."""
    rng = random.Random(23)
    recs = random_records(rng, chrom="1", n=1500, n_samples=N_SAMPLES,
                          spacing=10, p_symbolic=0.1, p_multiallelic=0.3,
                          p_no_acan=0.5)
    for rec in recs[::9]:
        rec.genotypes[rng.randrange(N_SAMPLES)] = "1|1|1|1"
        rec.ac = rec.an = None
    for i in range(20):
        recs.append(VcfRecord(
            chrom="1", pos=recs[-1].pos + 7, ref="AC",
            alts=[b * k for k in (1, 2, 3) for b in "ACGT"], vt="N/A",
            ac=None, an=None,
            genotypes=[f"{rng.randint(0, 12)}/{rng.randint(0, 12)}"
                       for _ in range(N_SAMPLES)],
        ))
    return build_index(recs, dataset_id="p", vcf_location="p.vcf",
                       sample_names=[f"S{i}" for i in range(N_SAMPLES)])


@pytest.fixture(scope="module")
def planes(cuda_device):
    shard = _plane_shard()
    return (sk.ScatterDeviceIndex(shard, cuda_device),
            pk.PlaneDeviceIndex(shard, cuda_device), shard)


def _masks(n, W, seed):
    g = np.random.default_rng(seed)
    m = g.integers(0, 2**32, (n, W), dtype=np.uint32)
    m &= g.integers(0, 2**32, (n, W), dtype=np.uint32)
    m[0::3] = 0xFFFFFFFF
    m[1::3] = 0
    return m


@pytest.mark.cuda
@pytest.mark.parametrize("with_counts", [True, False])
@pytest.mark.parametrize("exact_only", [True, False])
@pytest.mark.parametrize("C,cap,width", [(1, 128, 0), (2, 128, 100),
                                         (5, 512, 400), (17, 2048, 1500)])
def test_selected_kernel_matches_twin(planes, C, cap, width, exact_only,
                                      with_counts):
    index, pidx, _shard = planes
    ids, q8 = _inputs(index, 64, width, exact_only, seed=C + 7)
    mask = torch.from_numpy(_masks(64, pidx.n_words, C).view(np.int32)).to(
        index.device)
    R = min(1024, cap)
    trip = (pidx.gt2, pidx.tok1, pidx.tok2) if with_counts else (pidx.gt,) * 3
    got = sk.scatter_selected(
        index.tiles, pidx.gt, *trip, ids, q8, mask, T=index.tile, CAP=cap,
        C=C, exact_only=exact_only, R=R, with_counts=with_counts,
    )
    torch.cuda.synchronize()
    assert got[5] is not None
    assert int(got[0][:, 4].sum()) > 0
    for seg_k in (index.seg_k, None):
        want = sk.scatter_selected_reference(
            index.tiles, pidx.gt, *trip, ids, q8, mask, T=index.tile,
            CAP=cap, C=C, exact_only=exact_only, R=R,
            with_counts=with_counts, seg_k=seg_k,
        )
        for g, w in zip(got[:5], want):
            assert torch.equal(g, w)


def _tail_inputs(index, n, seed, first_row, width):
    """(tile_ids, q8) of n queries whose windows start on random rows from
    ``first_row`` on (the planes fixture's 12-alt records close the
    shard) and reach up to ``width`` rows on: any single base, DEL or
    INS, so a 12-alt record matches four lanes in a row."""
    rng = random.Random(seed)
    shard = index.shard
    pos = shard.cols["pos"]
    specs = []
    for _ in range(n):
        i = rng.randrange(first_row, shard.n_rows - 1)
        j = min(i + rng.randint(0, width), shard.n_rows - 1)
        kw = dict(chrom="1", start_min=int(pos[i]), start_max=int(pos[j]),
                  end_min=1, end_max=1 << 30)
        kw.update(rng.choice([{"alternate_bases": "N"},
                              {"variant_type": "DEL"},
                              {"variant_type": "INS"}]))
        specs.append(QuerySpec(**kw))
    enc = encode_queries(specs)
    lo, hi = window_bounds(index, enc)
    q8, _ = pack_q8(enc, lo, hi)
    dev = index.device
    return (torch.from_numpy((lo // index.tile).astype(np.int32)).to(dev),
            torch.from_numpy(q8).to(dev))


def _deadbeef_empty(monkeypatch):
    """torch.empty hands out buffers filled with 0xDEADBEEF, so a kernel
    output that is read before it is written shows."""
    empty = torch.empty

    def filled(*a, **kw):
        out = empty(*a, **kw)
        if out.dtype == torch.int32:
            out.fill_(-0x21524111)  # 0xDEADBEEF
        return out

    monkeypatch.setattr(torch, "empty", filled)


@pytest.mark.cuda
@pytest.mark.parametrize("with_counts", [True, False])
@pytest.mark.parametrize("R", [1, 31, 32, 33, 128, 1024])
def test_selected_kernel_record_caps(planes, R, with_counts, monkeypatch):
    """R across the warp edges of or_select's scans, on the 40-sample
    shard (two plane words, the second a tail word) near its 12-alt
    records, the outputs pre-filled with 0xDEADBEEF: equal to the twin,
    and for R > 32 some 12-alt record's matched lanes straddle slots 31
    and 32 (a warp boundary of the scans)."""
    index, pidx, shard = planes
    C = 1 if R <= 128 else 17
    cap = index.tile if C == 1 else (C - 1) * index.tile
    ids, q8 = _tail_inputs(index, 256, R, shard.n_rows - 400,
                           127 if C == 1 else 1500)
    mask = torch.from_numpy(_masks(256, pidx.n_words, R).view(np.int32)).to(
        index.device)
    trip = (pidx.gt2, pidx.tok1, pidx.tok2) if with_counts else (pidx.gt,) * 3
    kw = dict(T=index.tile, CAP=cap, C=C, R=R, with_counts=with_counts)
    _deadbeef_empty(monkeypatch)
    got = sk.scatter_selected(index.tiles, pidx.gt, *trip, ids, q8, mask, **kw)
    torch.cuda.synchronize()
    monkeypatch.undo()
    want = sk.scatter_selected_reference(index.tiles, pidx.gt, *trip, ids, q8,
                                         mask, **kw)
    for g, w in zip(got[:5], want):
        assert torch.equal(g, w)
    rows = got[1].cpu().numpy()
    rec = shard.cols["rec_id"]
    size = np.bincount(rec)
    spans = sum(1 for r in rows for k in range(31, R - 1, 32)
                if r[k] >= 0 and r[k + 1] >= 0 and rec[r[k]] == rec[r[k + 1]]
                and size[rec[r[k]]] == 12)
    assert (spans > 0) == (R > 32)
    assert int((rows >= 0).sum()) > 0 and (got[4] != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("with_counts", [True, False])
def test_selected_kernel_plane_rows_past_2_31_words(cuda_device, with_counts):
    """Plane rows past 2^31 words: 16384-word rows (the mask and OR words
    in shared memory, no gt cache) over 133120 rows, 8.7 GB a plane,
    queried on its last rows."""
    shard = synthetic_shard(133_120, seed=5, dataset_id="wide", chroms=["1"])
    index = sk.ScatterDeviceIndex(shard, cuda_device)
    w = 16384
    assert shard.n_rows * w > 2**31
    g = torch.Generator(device=cuda_device).manual_seed(5)
    planes = [torch.randint(-(2**31), 2**31, (shard.n_rows, w),
                            dtype=torch.int32, device=cuda_device,
                            generator=g)
              for _ in range(4 if with_counts else 1)]
    ids, q8 = _tail_inputs(index, 8, 3, shard.n_rows - 1500, 100)
    assert int(ids.min()) * index.tile * w > 2**31
    mask = torch.from_numpy(_masks(8, w, 2).view(np.int32)).to(cuda_device)
    trip = planes[1:] if with_counts else planes * 3
    kw = dict(T=index.tile, CAP=index.tile, C=2, R=index.tile,
              with_counts=with_counts)
    got = sk.scatter_selected(index.tiles, planes[0], *trip, ids, q8, mask,
                              **kw)
    torch.cuda.synchronize()
    want = sk.scatter_selected_reference(index.tiles, planes[0], *trip, ids,
                                         q8, mask, **kw)
    for a, b in zip(got[:5], want):
        assert torch.equal(a, b)
    assert int((got[1] >= 0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("with_counts", [True, False])
@pytest.mark.parametrize("sel", ["none", "some", "all"])
@pytest.mark.parametrize("R", [1, 128, 1000, 20000])
def test_plane_stats_kernel_matches_twin(planes, R, sel, with_counts):
    _index, pidx, shard = planes
    g = np.random.default_rng(R)
    dev = pidx.device
    rows = torch.from_numpy(
        g.integers(0, shard.n_rows, R).astype(np.int32)).to(dev)
    or_sel = torch.from_numpy({
        "none": np.zeros(R, np.int32), "all": np.ones(R, np.int32),
        "some": (g.random(R) < 0.3).astype(np.int32)}[sel]).to(dev)
    mask = torch.from_numpy(_masks(1, pidx.n_words, R)[0].view(np.int32)).to(dev)
    trip = (pidx.gt2, pidx.tok1, pidx.tok2) if with_counts else (pidx.gt,) * 3
    counts, or_words, seq = pk.plane_stats(
        pidx.gt, *trip, rows, or_sel, mask, with_counts=with_counts,
        with_or=sel != "none",
    )
    torch.cuda.synchronize()
    assert seq is not None
    want = pk.plane_stats_reference(
        pidx.gt, *trip, rows, or_sel, mask, with_counts=with_counts,
        with_or=sel != "none",
    )
    assert torch.equal(counts, want[0]) and torch.equal(or_words, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("with_counts", [True, False])
@pytest.mark.parametrize("sel", ["none", "some", "all"])
@pytest.mark.parametrize("R", [0, 1, 5, 7, 9, 63, 65, 2047, 7097, 70001])
def test_plane_stats_kernel_grid_edges(planes, R, sel, with_counts,
                                       monkeypatch):
    """R of no rows, one row, below one block's rows, not a multiple of a
    warp's row group, and past the grid's cap (several groups a warp),
    clamped row ids, or_sel none, some and all, three launches in a row
    (the fold's ticket resets), on 0xDEADBEEF-filled outputs: equal to
    the twin."""
    _index, pidx, shard = planes
    g = np.random.default_rng(R + 3)
    dev = pidx.device
    rows_np = g.integers(-5, shard.n_rows + 5, R).astype(np.int32)
    rows = torch.from_numpy(rows_np).to(dev)
    or_sel = torch.from_numpy({
        "none": np.zeros(R, np.int32), "all": np.ones(R, np.int32),
        "some": (g.random(R) < 0.01).astype(np.int32)}[sel]).to(dev)
    trip = (pidx.gt2, pidx.tok1, pidx.tok2) if with_counts else (pidx.gt,) * 3
    kw = dict(with_counts=with_counts, with_or=sel != "none")
    for k in range(3):
        mask = torch.from_numpy(_masks(3, pidx.n_words, R)[k].view(
            np.int32)).to(dev)
        with monkeypatch.context() as mp:
            _deadbeef_empty(mp)
            counts, or_words, seq = pk.plane_stats(pidx.gt, *trip, rows,
                                                   or_sel, mask, **kw)
            torch.cuda.synchronize()
        assert seq is not None
        want = pk.plane_stats_reference(pidx.gt, *trip, rows, or_sel, mask,
                                        **kw)
        assert torch.equal(counts, want[0]) and torch.equal(or_words, want[1])


@pytest.mark.cuda
def test_staged_upload_in_chunks(cuda_device):
    a = np.random.default_rng(1).integers(0, 2**32, (10_001, 79),
                                          dtype=np.uint32)
    got = pk.staged_upload(a, cuda_device, chunk_bytes=64 * 1024)
    assert got.device.type == "cuda" and got.dtype == torch.int32
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), a)


@pytest.mark.cuda
def test_selected_batch_on_card_equals_cpu(planes):
    index, pidx, shard = planes
    rng = random.Random(13)
    pos = shard.cols["pos"]
    specs = []
    for _ in range(150):
        i = rng.randrange(shard.n_rows - 2000)
        specs.append(QuerySpec(
            chrom="1", start_min=int(pos[i]),
            start_max=int(pos[i + rng.choice([0, 50, 400, 1500, 1999])]),
            end_min=1, end_max=1 << 30,
            alternate_bases=rng.choice([shard.row_alt(i), "N", None]),
        ))
    masks = _masks(len(specs), pidx.n_words, 5)
    cpu = (sk.ScatterDeviceIndex(shard, "cpu"), pk.PlaneDeviceIndex(shard, "cpu"))
    for with_counts in (True, False):
        got = sk.run_selected_scattered(index, pidx, specs, masks,
                                        record_cap=256, with_counts=with_counts)
        want = sk.run_selected_scattered(*cpu, specs, masks, record_cap=256,
                                         with_counts=with_counts)
        for f in SELECTED_FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert got.overflow.any() and (~got.overflow).sum() > 20


SELECTED_FIELDS = ("exists", "call_count", "n_variants", "all_alleles_count",
                   "n_matched", "overflow", "rows", "pc_call", "pc_tok",
                   "or_words")


@pytest.mark.cuda
def test_engine_selected_one_launch_per_request(planes, cuda_device):
    """Each plane-reading request is one fused kernel launch; its
    answer equals the CPU engine's."""
    _index, _pidx, shard = planes
    engines = [
        VariantEngine(BeaconConfig(engine=EngineConfig(microbatch=False)),
                      device=d) for d in (cuda_device, "cpu")
    ]
    try:
        for e in engines:
            e.add_index(shard)
        (_d, _v, (_s, _i, p)), = engines[0].indexes_for([])
        assert p is not None and p.gt.device.type == "cuda"
        rng = random.Random(3)
        pos = shard.cols["pos"]
        for k in range(12):
            q = int(pos[rng.randrange(shard.n_rows)])
            doc = dict(dataset_ids=["p"], reference_name="1",
                       start_min=q - 200, start_max=q + 200, end_min=1,
                       end_max=1 << 30, alternate_bases="N",
                       requested_granularity="record", include_datasets="HIT",
                       include_samples=True)
            if k % 2:
                doc.update(sample_names={"p": ["S1", "S7", "S39"]},
                           selected_samples_only=True)
            telemetry.reset_launch_counts()
            got = engines[0].search(VariantQueryPayload(**doc))
            assert sk.scatter_selected_launches == 1
            assert sk.scatter_match_launches == 0
            assert got == engines[1].search(VariantQueryPayload(**doc))
    finally:
        for e in engines:
            e.close()


DISTINCT_CASES = distinct_key_cases()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(DISTINCT_CASES))
def test_distinct_kernel_matches_twin(cuda_device, case):
    """Every key equal, one column differing, high-bit patterns, pad
    rows, 0-1000 keys: the hash-set kernel equals the sort twin."""
    keys = torch.from_numpy(DISTINCT_CASES[case]).to(cuda_device)
    telemetry.reset_launch_counts()
    count, seq = dc.distinct_count(keys)
    torch.cuda.synchronize()
    assert (seq is not None) == (keys.shape[0] > 0)
    assert dc.distinct_count_launches == int(keys.shape[0] > 0)
    assert int(count) == int(dc.distinct_count_reference(keys))


@pytest.mark.cuda
@pytest.mark.parametrize("n,distinct", [(3_000_000, 1_000_000),
                                        (2_000_000, 1_999_000)])
def test_distinct_kernel_at_size(cuda_device, n, distinct):
    """Millions of keys with many or few duplicates, unpadded and as a
    padded partition_keys block."""
    rng = np.random.default_rng(n)
    base = rng.integers(-(2**31), 2**31 - 1, size=(distinct, 6),
                        dtype=np.int64).astype(np.int32)
    base[:, 0] = rng.integers(0, 25, distinct)
    keys = base[rng.integers(0, distinct, n)]
    want = len(np.unique(keys, axis=0))
    for form in (keys, dc.partition_keys(keys, 1)[0]):
        t = torch.from_numpy(np.ascontiguousarray(form)).to(cuda_device)
        count, _seq = dc.distinct_count(t)
        torch.cuda.synchronize()
        assert int(count) == int(dc.distinct_count_reference(t)) == want


def _distinct_keys(n, distinct, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(-(2**31), 2**31 - 1, size=(distinct, 6),
                        dtype=np.int64).astype(np.int32)
    base[:, 0] = rng.integers(0, 25, distinct)
    return base[rng.integers(0, distinct, n)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,plans", [
    ("all_equal", [(0, 1), (2, 64)]),
    ("high_bits", [(0, 16), (2, 64)]),
    ("three_million", [(6, 3072), (8, 256)]),
])
def test_distinct_kernel_spills_exactly(cuda_device, case, plans):
    """Few buckets and a small set make buckets spill to further passes
    (counted in ``spills``): the count stays exact, one launch record
    each."""
    keys = (_distinct_keys(3_000_000, 1_000_000, 3) if case == "three_million"
            else DISTINCT_CASES[case])
    t = torch.from_numpy(np.ascontiguousarray(keys)).to(cuda_device)
    want = int(dc.distinct_count_reference(t))
    for log2, limit in plans:
        spills = torch.zeros((), dtype=torch.int64, device=cuda_device)
        telemetry.reset_launch_counts()
        count, _seq = dc.distinct_count(t, log2_buckets=log2,
                                        table_limit=limit, spills=spills)
        torch.cuda.synchronize()
        assert dc.distinct_count_launches == 1
        assert int(count) == want
        assert (int(spills) > 0) == (case != "all_equal")


@pytest.mark.cuda
def test_distinct_device_on_card_equals_cpu(cuda_device):
    shard = synthetic_shard(300_000, seed=5)
    rows = np.sort(np.random.default_rng(6).choice(shard.n_rows, 150_000,
                                                   replace=False))
    shards = [shard, subset_shard(shard, rows, dataset_id="again")]
    telemetry.reset_launch_counts()
    got = dc.distinct_count_device(shards)
    assert dc.distinct_count_launches == 1
    assert got == dc.distinct_count_device(shards, device="cpu")
    assert got == dc.distinct_count_device(shards[:1], device=cuda_device)


@pytest.mark.cuda
def test_probes_time_on_card(index, planes):
    """The device time probes on CUDA events: positive seconds, their
    launches counted as the match and plane-stats kernels'."""
    shard = index.shard
    pos = shard.cols["pos"]
    specs = [QuerySpec(chrom="1", start_min=int(pos[i]),
                       start_max=int(pos[i + (i % 3) * 100]), end_min=1,
                       end_max=1 << 30, alternate_bases=shard.row_alt(i))
             for i in range(0, 1500, 15)]
    telemetry.reset_launch_counts()
    per, gathered = sk.device_time_probe(index, specs, iters=8)
    assert 0.0 < per < 1.0 and gathered > 0
    assert sk.scatter_match_launches > 0
    _index, pidx, _shard = planes
    rows = np.arange(0, pidx.n_rows, 5, dtype=np.int32)
    mask = pk.sample_mask_words(range(0, 40, 3), pidx.n_words)
    seconds = pk.device_plane_probe(pidx, rows, mask, iters=8)
    assert 0.0 < seconds < 1.0 and pk.plane_stats_launches > 0


def _stack_shards():
    """The fused shards (no planes) and, for the selected kernel, the
    40-sample plane shard beside a 70-sample one (three plane words: the
    stack's W is the widest)."""
    rng = random.Random(29)
    wide = random_records(rng, chrom="1", n=1200, n_samples=70, spacing=12,
                          p_multiallelic=0.3, p_no_acan=0.4)
    wide = build_index(wide, dataset_id="w", vcf_location="w.vcf",
                       sample_names=[f"W{i}" for i in range(70)])
    return _fused_shards(), [_plane_shard(), wide]


@pytest.fixture(scope="module")
def stacks(cuda_device):
    plain, with_planes = _stack_shards()
    # a padding dataset in each stack; mesh entries of the same card
    mesh = tm.make_mesh(devices=[cuda_device] * 2)
    qs = tm.StackedIndex(plain, n_datasets_padded=4)
    ps = tm.StackedIndex(with_planes, n_datasets_padded=4, with_planes=True)
    assert ps.has_count_planes and ps.plane_words == 3
    return (mesh, qs, qs.shard_to_mesh(mesh), ps, ps.shard_to_mesh(mesh),
            plain, with_planes)


def _stack_q(specs, device):
    return torch.from_numpy(tk.pack_queries(encode_queries(specs),
                                            fused=False)).to(device)


@pytest.fixture(scope="module")
def local_stacks(cuda_device):
    """One-entry stacks of d_local datasets for the stacked query's
    clusters (at most 8 blocks, so 9 and 17 loop over datasets): the
    fused shards over and over, the last dataset a padding one (all-zero
    segment row) once d_local > 1."""
    shards = _fused_shards()
    out = {}
    for d_local in (1, 3, 8, 9, 17):
        real = max(1, d_local - 1)
        stack = tm.StackedIndex([shards[i % len(shards)] for i in range(real)],
                                n_datasets_padded=d_local)
        (blk,) = stack.shard_to_mesh(tm.make_mesh(devices=[cuda_device]))
        assert blk.n_datasets == d_local
        out[d_local] = (stack, blk)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("d_local", [2, 1, 3, 8, 9, 17])
@pytest.mark.parametrize("b", [0, 1, 16, 64, 512])
@pytest.mark.parametrize("window_cap,record_cap", [(2048, 1024), (256, 16)])
def test_stacked_query_kernel_matches_twin(stacks, local_stacks, b,
                                           window_cap, record_cap, d_local):
    """Each block of datasets (d_local 2: the two-entry mesh's blocks,
    each with a padding dataset; else a one-entry stack) equals the twin
    in out and agg, b = 0 included (an all-zero agg, no launch)."""
    if d_local == 2:
        _mesh, qs, blocks, *_ = stacks
        n_iters = qs.n_iters
    else:
        stack, blk = local_stacks[d_local]
        blocks, n_iters = [blk], stack.n_iters
    specs, _sids = _fused_specs(_stack_shards()[0], max(b, 1), seed=7 * b)
    for blk in blocks:
        q = _stack_q(specs, blk.device)[:b]
        kw = dict(window_cap=window_cap, record_cap=record_cap,
                  n_iters=n_iters)
        telemetry.reset_launch_counts()
        out, agg, seq = tm.stacked_query(blk.columns, blk.alt_prefix,
                                         blk.offsets, q, **kw)
        torch.cuda.synchronize()
        assert (seq is None) == (b == 0)
        assert tm.stacked_query_launches == (b > 0)
        want = tm.local_query_reference(blk.columns, blk.alt_prefix,
                                        blk.offsets, q, **kw)
        assert torch.equal(out, want[0]) and torch.equal(agg, want[1])
        assert agg.shape == (b, tm.N_STACK_AGG)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 16, 64])
@pytest.mark.parametrize("has_counts", [True, False])
@pytest.mark.parametrize("record_cap", [1024, 16])
def test_stacked_selected_kernel_matches_twin(stacks, b, has_counts,
                                              record_cap):
    *_, ps, pblocks, _plain, with_planes = stacks
    specs, _sids = _fused_specs(with_planes, b, seed=11 * b)
    for g, blk in enumerate(pblocks):
        q = _stack_q(specs, blk.device)
        masks = _masks(blk.n_datasets, ps.plane_words, seed=b + g)
        m = torch.from_numpy(masks.view(np.int32)).to(blk.device)
        planes = blk.planes if has_counts else (blk.planes[0],) * 4
        kw = dict(window_cap=2048, record_cap=record_cap,
                  n_iters=ps.n_iters, has_counts=has_counts)
        got = tm.stacked_selected(blk.columns, blk.alt_prefix, blk.offsets,
                                  *planes, m, q, **kw)
        torch.cuda.synchronize()
        assert got[-1] is not None
        want = tm.local_selected_reference(blk.columns, blk.alt_prefix,
                                           blk.offsets, *planes, m, q, **kw)
        for a, w in zip(got[:-1], want):
            assert torch.equal(a, w)


@pytest.fixture(scope="module")
def local_plane_stacks(cuda_device):
    """One-entry plane stacks of d_local datasets for the stacked selected
    kernel's clusters (at most 8 blocks, so 9 and 17 loop over datasets):
    the 40- and 70-sample plane shards in turn, all four planes, the last
    dataset a padding one once d_local > 1."""
    shards = _stack_shards()[1]
    out = {}
    for d_local in (1, 2, 3, 8, 9, 17):
        real = max(1, d_local - 1)
        stack = tm.StackedIndex([shards[i % 2] for i in range(real)],
                                n_datasets_padded=d_local, with_planes=True)
        (blk,) = stack.shard_to_mesh(tm.make_mesh(devices=[cuda_device]))
        assert blk.n_datasets == d_local and stack.has_count_planes
        out[d_local] = (stack, blk, shards)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("d_local", [1, 2, 3, 8, 9, 17])
@pytest.mark.parametrize("b", [1, 16, 64])
@pytest.mark.parametrize("has_counts", [True, False])
def test_stacked_selected_clusters_match_twin(local_plane_stacks, d_local, b,
                                              has_counts, monkeypatch):
    """One cluster of min(d_local, 8) blocks per query: every output and
    agg equal to the twin's, the outputs pre-filled with 0xDEADBEEF (so
    nothing is read before the launch writes it)."""
    stack, blk, shards = local_plane_stacks[d_local]
    specs, _sids = _fused_specs(shards, b, seed=13 * b + d_local)
    q = _stack_q(specs, blk.device)
    masks = _masks(blk.n_datasets, stack.plane_words, seed=b + d_local)
    m = torch.from_numpy(masks.view(np.int32)).to(blk.device)
    planes = blk.planes if has_counts else (blk.planes[0],) * 4
    kw = dict(window_cap=2048, record_cap=64, n_iters=stack.n_iters,
              has_counts=has_counts)
    args = (blk.columns, blk.alt_prefix, blk.offsets, *planes, m, q)
    _deadbeef_empty(monkeypatch)
    telemetry.reset_launch_counts()
    got = tm.stacked_selected(*args, **kw)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert got[-1] is not None and tm.stacked_selected_launches == 1
    want = tm.local_selected_reference(*args, **kw)
    for a, w in zip(got[:-1], want):
        assert torch.equal(a, w)
    assert b == 1 or int((got[1] >= 0).sum()) > 0


@pytest.mark.cuda
def test_sharded_on_card_equals_cpu(stacks):
    """Both entry points on the two-entry card mesh (the cross-block sum
    on the card) give the CPU mesh's results."""
    mesh, qs, blocks, ps, pblocks, plain, with_planes = stacks
    cpu_mesh = tm.make_mesh(devices=["cpu"] * 2)
    specs, _sids = _fused_specs(plain, 200, seed=3)
    got = tm.sharded_query(blocks, specs, mesh=mesh, n_iters=qs.n_iters)
    want = tm.sharded_query(qs.shard_to_mesh(cpu_mesh), specs,
                            mesh=cpu_mesh, n_iters=qs.n_iters)
    for part_got, part_want in zip(got, want):
        for k in part_want:
            np.testing.assert_array_equal(part_got[k], part_want[k], k)
    specs, _sids = _fused_specs(with_planes, 64, seed=4)
    masks = _masks(4, ps.plane_words, seed=5)
    got = tm.sharded_selected_query(pblocks, specs, masks, mesh=mesh,
                                    n_iters=ps.n_iters, has_counts=True)
    want = tm.sharded_selected_query(ps.shard_to_mesh(cpu_mesh), specs,
                                     masks, mesh=cpu_mesh,
                                     n_iters=ps.n_iters, has_counts=True)
    for part_got, part_want in zip(got, want):
        for k in part_want:
            np.testing.assert_array_equal(part_got[k], part_want[k], k)


@pytest.mark.cuda
def test_engine_mesh_leg_on_card(cuda_device, monkeypatch):
    """The engine's mesh leg on the card (its mesh patched to two
    entries of the one card) answers as the CPU engine does, with one
    stacked launch per mesh entry per request."""
    _plain, with_planes = _stack_shards()
    engines = []
    for dev in (cuda_device, "cpu"):
        eng = VariantEngine(BeaconConfig(engine=EngineConfig(
            microbatch=False)), device=dev)
        monkeypatch.setattr(tm, "mesh_devices",
                            lambda device: [torch.device(device)] * 2)
        for s in with_planes:
            eng.add_index(s)
        engines.append(eng)
    try:
        payload = VariantQueryPayload(
            dataset_ids=[], reference_name="1", start_min=1,
            start_max=30_000, end_min=1, end_max=1 << 30,
            alternate_bases="N", requested_granularity="record",
            include_datasets="HIT", include_samples=True,
            selected_samples_only=True,
            sample_names={"p": ["S1", "S7", "S30"], "w": ["W3", "W69"]})
        telemetry.reset_launch_counts()
        got = engines[0].search(payload)
        assert tm.stacked_selected_launches == 2
        assert got == engines[1].search(payload)
        assert engines[0].mesh_selected_searches == 1
    finally:
        for eng in engines:
            eng.close()


@pytest.fixture(scope="module")
def fused_meshes(cuda_device):
    """Mesh-sharded fused indexes on two and three entries of the card:
    the plain shards, and the plane shards (40 and 70 samples, count
    planes) whose last group of three entries is empty."""
    plain, with_planes = _stack_shards()
    out = {}
    for n in (2, 3):
        mesh = tm.make_mesh(devices=[cuda_device] * n)
        out[("plain", n)] = (tm.MeshFusedIndex(plain, mesh), plain)
        out[("planes", n)] = (
            tm.MeshFusedIndex(with_planes, mesh, with_planes=True),
            with_planes)
    return out


def _fused_inputs(mfi, specs, sids, layout, masks=None, counts=None):
    """Per entry (block, packed slots, keyword arguments of mesh_fused),
    laid out as run_mesh_queries lays the batch out."""
    entries = mfi.launch_inputs(encode_queries(specs, shard_ids=sids), layout,
                                sample_masks=masks, mask_counts=counts)[0]
    return [(blk, q, dict(kw, window_cap=2048, record_cap=64))
            for blk, q, kw in entries]


LAYOUTS = (0, 1, 2)  # tm.LAYOUT_OWNER, LAYOUT_SLICED, LAYOUT_REPLICATED


def _dense_plane_shard(name, seed):
    """40 samples, some genotype-derived counts, and a run of 1500
    single-base SNVs: an any-base query over the run matches more than
    R = 1024 rows."""
    rng = random.Random(seed)
    recs = random_records(rng, chrom="1", n=300, n_samples=N_SAMPLES,
                          spacing=10, p_multiallelic=0.3, p_no_acan=0.5)
    start = recs[-1].pos + 10
    for i in range(1500):
        counted = i % 3 != 0
        recs.append(VcfRecord(
            chrom="1", pos=start + i, ref="A", alts=["T"], vt="SNP",
            ac=[i % 5] if counted else None, an=80 if counted else None,
            genotypes=[rng.choice(["0|0", "0|1", "1|1"])
                       for _ in range(N_SAMPLES)]))
    return build_index(recs, dataset_id=name, vcf_location=f"{name}.vcf",
                        sample_names=[f"S{i}" for i in range(N_SAMPLES)])


@pytest.fixture(scope="module")
def dense_mesh(cuda_device):
    shards = [_dense_plane_shard("x", 41), _dense_plane_shard("y", 43)]
    mfi = tm.MeshFusedIndex(shards, tm.make_mesh(devices=[cuda_device] * 2),
                            with_planes=True)
    assert mfi.has_count_planes
    return mfi, shards


def _run_specs(shards):
    """Any-base queries over each shard's SNV run: all of it (1500
    matched rows, R = 1024 lanes all valid), and prefixes whose matched
    rows end inside or across the cluster's shares, then points."""
    specs, sids = [], []
    for sid, sh in enumerate(shards):
        start = int(sh.cols["pos"][-1]) - 1499
        for width in (1499, 1030, 700, 129, 40, 7, 0):
            specs.append(QuerySpec(chrom="1", start_min=start,
                                   start_max=start + width, end_min=1,
                                   end_max=1 << 30, alternate_bases="N"))
            sids.append(sid)
    return specs, sids


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 79])
@pytest.mark.parametrize("has_counts", [True, False])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_fused_cluster_matches_twin(dense_mesh, W, has_counts, layout):
    """The cluster launch with planes at R = 1024: slots whose 1024
    lanes are all valid and slots whose n_valid ends inside one block's
    share or across several, plane widths 79 (2504 samples) and 1, counts
    on and off with use_counts mixed per slot, and the other entries'
    slots of the sliced layout. Random planes and masks of width W stand
    in for the index's: kernel and twin read the same ones."""
    mfi, shards = dense_mesh
    specs, sids = _run_specs(shards)
    more, more_sids = _fused_specs(shards, 24, seed=W + layout)
    specs, sids = specs + more, sids + more_sids
    g = np.random.default_rng(3 * W + has_counts)
    full = 0
    for blk, q, kw in _fused_inputs(mfi, specs, sids, layout):
        dev, n_pad, s = blk.device, blk.columns.shape[1], q.shape[0]
        rand = lambda *shape: torch.from_numpy(g.integers(
            -(2**31), 2**31, size=shape, dtype=np.int64).astype(
                np.int32)).to(dev)
        kw = dict(kw, record_cap=1024, has_counts=has_counts,
                  planes=tuple(rand(n_pad, W)
                               for _ in range(4 if has_counts else 1)),
                  masks=torch.from_numpy(_masks(s, W, seed=W).view(
                      np.int32)).to(dev),
                  use_counts=torch.from_numpy(
                      (np.arange(s) % 2).astype(np.int32)).to(dev))
        args = (blk.columns, blk.alt_prefix, blk.offsets, blk.seg_base, q)
        got, seq = tm.mesh_fused(*args, **kw)
        torch.cuda.synchronize()
        assert seq is not None
        want = tm.local_fused_reference(*args, **kw)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        full += int((want["agg"][:, 3] >= 1024).sum())
    assert full > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["plain", "planes"])
@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("b", [1, 16, 64, 512])
def test_mesh_fused_kernel_matches_twin(fused_meshes, kind, n, layout, b):
    """Both entry points (match-only, with planes), every layout, against
    the twin on every entry; counts on for every other query."""
    mfi, shards = fused_meshes[(kind, n)]
    specs, sids = _fused_specs(shards, b, seed=13 * b + n)
    masks = counts = None
    if kind == "planes":
        masks = _masks(b, mfi.plane_words, seed=b)
        counts = np.arange(b) % 2 == 0
    for blk, q, kw in _fused_inputs(mfi, specs, sids, layout, masks, counts):
        args = (blk.columns, blk.alt_prefix, blk.offsets, blk.seg_base, q)
        got, seq = tm.mesh_fused(*args, **kw)
        torch.cuda.synchronize()
        assert seq is not None
        want = tm.local_fused_reference(*args, **kw)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def wide_fused_mesh(cuda_device):
    """A two-entry match-only index of 21 shards: d_local 11, past the
    9 datasets whose segment rows the kernel loads beside the query row."""
    base = _fused_shards()
    shards = []
    for i in range(21):
        sh = base[i % 3]
        keep = np.random.default_rng(i).choice(sh.n_rows, sh.n_rows * 9 // 10,
                                               replace=False)
        shards.append(subset_shard(sh, np.sort(keep), dataset_id=f"d{i}"))
    mfi = tm.MeshFusedIndex(shards, tm.make_mesh(devices=[cuda_device] * 2))
    assert mfi.d_local == 11
    return mfi, shards


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["narrow", "wide"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("b", [1, 2, 4, 6, 8, 10, 12, 14])
def test_mesh_fused_match_clusters_match_twin(fused_meshes, wide_fused_mesh,
                                              kind, layout, b, monkeypatch):
    """The match-only cluster launch at the pod tier's slot counts (1-14)
    in every layout, d_local 1 (segment rows loaded beside the query row)
    and 11 (loaded after it), on 0xDEADBEEF-filled outputs."""
    mfi, shards = (fused_meshes[("plain", 3)] if kind == "narrow"
                   else wide_fused_mesh)
    specs, sids = _fused_specs(shards, b, seed=7 * b + layout)
    cases = _fused_inputs(mfi, specs, sids, layout)
    for blk, q, kw in cases:
        args = (blk.columns, blk.alt_prefix, blk.offsets, blk.seg_base, q)
        want = tm.local_fused_reference(*args, **kw)
        with monkeypatch.context() as mp:
            _deadbeef_empty(mp)
            got, seq = tm.mesh_fused(*args, **kw)
            torch.cuda.synchronize()
        assert seq is not None
        for k in want:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["plain", "planes"])
@pytest.mark.parametrize("layout", ["owner", "sliced", "replicated"])
def test_run_mesh_queries_on_card_equals_cpu(fused_meshes, kind, layout):
    """The whole mesh launch on three entries of the card (J6 on each,
    then P1 in the combined layouts) answers as the CPU mesh does, with
    one mesh_fused launch per entry and n(n-1) ring steps."""
    from sbeacon_tpu_torch.ops import gather_kernel as tg

    mfi, shards = fused_meshes[(kind, 3)]
    cpu = tm.MeshFusedIndex(shards, tm.make_mesh(devices=["cpu"] * 3),
                            with_planes=kind == "planes",
                            layout={"owner": tm.LAYOUT_OWNER,
                                    "sliced": tm.LAYOUT_SLICED,
                                    "replicated": tm.LAYOUT_REPLICATED}[layout])
    mfi.layout = cpu.layout
    specs, sids = _fused_specs(shards, 48, seed=5)
    kw = dict(window_cap=2048, record_cap=64)
    if kind == "planes":
        kw.update(sample_masks=_masks(48, mfi.plane_words, seed=6),
                  mask_counts=np.arange(48) % 3 == 0)
    telemetry.reset_launch_counts()
    got = mfi.run_mesh_queries(encode_queries(specs, shard_ids=sids), **kw)
    assert tm.mesh_fused_launches == 3
    assert tg.ring_gather_launches == (0 if layout == "owner" else 6)
    want = cpu.run_mesh_queries(encode_queries(specs, shard_ids=sids), **kw)
    for f in ("exists", "call_count", "n_variants", "all_alleles_count",
              "n_matched", "overflow", "rows", "pc_call", "pc_tok",
              "or_words"):
        a, w = getattr(got, f), getattr(want, f)
        assert (a is None) == (w is None), f
        if a is not None:
            np.testing.assert_array_equal(a, w, f)


def _ring_blocks(n, shape, device, seed, misaligned):
    """n seeded int32 blocks over the whole int32 range (wraparound), on
    ``device``; misaligned ones start 4 bytes into a buffer (the word
    kernel)."""
    g = np.random.default_rng(seed)
    numel = int(np.prod(shape))
    out = []
    for _ in range(n):
        t = torch.from_numpy(g.integers(-2**31, 2**31, size=numel,
                                        dtype=np.int64).astype(np.int32))
        if misaligned:
            base = torch.empty(numel + 1, dtype=torch.int32, device=device)
            base[1:] = t.to(device)
            out.append(base[1:].view(shape))
        else:
            out.append(t.to(device).view(shape))
    return out


def _cuda_kernels(fn):
    """The names of the CUDA kernels one call of ``fn`` runs (a
    torch.profiler trace of the card), in launch order. The call sits
    50 ms inside each end of the traced window: a window that ends right
    after the call now and then holds no device event at all."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    return [ev.name for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("shape", [(64, 1024), (64, 3 * 1024 + 79), (7, 13)])
@pytest.mark.parametrize("misaligned", [False, True])
def test_ring_gather_matches_twin(cuda_device, n, shape, misaligned):
    """The ring on n entries of the card: every entry ends with the int32
    sum (wrapping), the inputs unchanged, n(n-1) launches and no other
    kernel (no copy of an input partial). Then single ring steps, out of
    place (own != acc) and in place (own is acc), each with and without
    next, against the twin's sum."""
    from sbeacon_tpu_torch.ops import gather_kernel as tg

    parts = _ring_blocks(n, shape, cuda_device, n, misaligned)
    keep = [p.clone() for p in parts]
    telemetry.reset_launch_counts()
    got = tg.ring_gather(parts)
    torch.cuda.synchronize()
    assert tg.ring_gather_launches == n * (n - 1)
    want = tg.gather_partials_portable([p.cpu() for p in parts])
    for x in got:
        assert torch.equal(x.cpu(), want)
    for a, b in zip(parts, keep):
        assert torch.equal(a, b)
    kernels = _cuda_kernels(lambda: tg.ring_gather(parts))
    assert len(kernels) == n * (n - 1), kernels
    assert all("ring_step" in k for k in kernels), kernels

    src, own, acc, nxt = _ring_blocks(4, shape, cuda_device, 10 + n,
                                      misaligned)
    src0, own0, acc0 = src.clone(), own.clone(), acc.clone()
    for in_place in (False, True):
        for with_next in (False, True):
            a = acc0.clone() if in_place else acc
            a_before = a.clone()
            telemetry.reset_launch_counts()
            tg.ring_step(src, nxt if with_next else None, a,
                         own=a if in_place else own)
            torch.cuda.synchronize()
            assert tg.ring_gather_launches == 1
            base = a_before if in_place else own0
            assert torch.equal(
                a.cpu(), tg.gather_partials_portable([base.cpu(),
                                                      src0.cpu()]))
            if with_next:
                assert torch.equal(nxt, src0)
            assert torch.equal(src, src0) and torch.equal(own, own0)
            nxt.zero_()


# The tests that read a torch.profiler trace sit together here, after the
# ring gather's: once a process has run one profiler session, a later
# session that follows about a million other kernel launches records no
# device event, and the tests above launch that many.


@pytest.mark.cuda
def test_stacked_query_launches_no_fill(local_stacks):
    """One stacked_query call runs its kernel and no other (agg is not
    filled before the launch), on a stack of 9 datasets."""
    stack, blk = local_stacks[9]
    specs, _sids = _fused_specs(_stack_shards()[0], 64, seed=5)
    q = _stack_q(specs, blk.device)
    kw = dict(window_cap=2048, record_cap=1024, n_iters=stack.n_iters)
    run = lambda: tm.stacked_query(blk.columns, blk.alt_prefix, blk.offsets,
                                   q, **kw)
    run()
    torch.cuda.synchronize()
    kernels = _cuda_kernels(run)
    assert len(kernels) == 1 and "stacked_query_kernel" in kernels[0], kernels


@pytest.mark.cuda
def test_match_kernels_launch_one_kernel(index, fused_meshes):
    """One scatter_match call and one match-only mesh_fused call each run
    their kernel and no other."""
    ids, q8 = (torch.from_numpy(x).to(index.device)
               for x in _main_path_slots(index, 6, 100, False, seed=2))
    run = lambda: sk.scatter_match(index.tiles, ids, q8, T=index.tile,
                                   CAP=128, C=2)
    run()
    torch.cuda.synchronize()
    kernels = _cuda_kernels(run)
    assert len(kernels) == 1 and "scatter_match_kernel" in kernels[0], kernels
    mfi, shards = fused_meshes[("plain", 2)]
    specs, sids = _fused_specs(shards, 8, seed=9)
    (blk, q, kw), *_rest = _fused_inputs(mfi, specs, sids, tm.LAYOUT_OWNER)
    run = lambda: tm.mesh_fused(blk.columns, blk.alt_prefix, blk.offsets,
                                blk.seg_base, q, **kw)
    run()
    torch.cuda.synchronize()
    kernels = _cuda_kernels(run)
    assert len(kernels) == 1 and "mesh_fused_kernel" in kernels[0], kernels


@pytest.mark.cuda
@pytest.mark.parametrize("with_counts", [True, False])
def test_selected_kernel_launches_one_kernel(planes, with_counts):
    """One scatter_selected call runs its kernel and no other."""
    index, pidx, _shard = planes
    ids, q8 = _inputs(index, 16, 100, False, seed=3)
    mask = torch.from_numpy(_masks(16, pidx.n_words, 3).view(np.int32)).to(
        index.device)
    trip = (pidx.gt2, pidx.tok1, pidx.tok2) if with_counts else (pidx.gt,) * 3
    run = lambda: sk.scatter_selected(
        index.tiles, pidx.gt, *trip, ids, q8, mask, T=index.tile, CAP=128,
        C=2, R=128, with_counts=with_counts)
    run()
    torch.cuda.synchronize()
    kernels = _cuda_kernels(run)
    assert len(kernels) == 1 and "scatter_selected_kernel" in kernels[0], (
        kernels)


@pytest.mark.cuda
@pytest.mark.parametrize("has_counts", [True, False])
def test_stacked_selected_launches_no_fill(local_plane_stacks, has_counts):
    """One stacked_selected call runs its kernel and no other (agg is not
    filled before the launch), on a stack of 9 datasets."""
    stack, blk, shards = local_plane_stacks[9]
    specs, _sids = _fused_specs(shards, 64, seed=5)
    q = _stack_q(specs, blk.device)
    m = torch.from_numpy(_masks(9, stack.plane_words, 1).view(np.int32)).to(
        blk.device)
    planes = blk.planes if has_counts else (blk.planes[0],) * 4
    run = lambda: tm.stacked_selected(
        blk.columns, blk.alt_prefix, blk.offsets, *planes, m, q,
        window_cap=2048, record_cap=1024, n_iters=stack.n_iters,
        has_counts=has_counts)
    run()
    torch.cuda.synchronize()
    kernels = _cuda_kernels(run)
    assert len(kernels) == 1 and "stacked_selected_kernel" in kernels[0], (
        kernels)


@pytest.mark.cuda
def test_bisect_query_launches_one_kernel(fused):
    """One bisect_query call runs its kernel and no other (out is not
    filled before the launch)."""
    index, _cpu, shards = fused
    specs, sids = _fused_specs(shards, 64, seed=6)
    q = torch.from_numpy(tk.pack_queries(
        encode_queries(specs, shard_ids=sids), fused=True)).to(index.device)
    run = lambda: tk.bisect_query(index.columns, index.alt_prefix,
                                  index.offsets, q, window_cap=2048,
                                  record_cap=1024, n_iters=index.n_iters)
    run()
    torch.cuda.synchronize()
    kernels = _cuda_kernels(run)
    assert len(kernels) == 1 and "bisect_query_kernel" in kernels[0], kernels


@pytest.mark.cuda
@pytest.mark.parametrize("with_counts", [True, False])
def test_plane_stats_launches_one_kernel(planes, with_counts):
    """One plane_stats call with the OR over several blocks runs its
    kernel and no other: no fill of or_words, the fold inside."""
    _index, pidx, shard = planes
    dev = pidx.device
    rows = torch.arange(0, 7000, dtype=torch.int32, device=dev) % shard.n_rows
    or_sel = torch.ones(7000, dtype=torch.int32, device=dev)
    mask = torch.full((pidx.n_words,), -1, dtype=torch.int32, device=dev)
    trip = (pidx.gt2, pidx.tok1, pidx.tok2) if with_counts else (pidx.gt,) * 3
    run = lambda: pk.plane_stats(pidx.gt, *trip, rows, or_sel, mask,
                                 with_counts=with_counts, with_or=True)
    run()
    torch.cuda.synchronize()
    kernels = _cuda_kernels(run)
    assert len(kernels) == 1 and "plane_stats_kernel" in kernels[0], kernels


@pytest.mark.cuda
def test_tier_on_card_equals_cpu(cuda_device):
    """The pod tier over two entries of the card answers as over two CPU
    entries, through mesh_fused."""
    from sbeacon_tpu_torch.parallel.dispatch import MeshDispatchTier

    _plain, with_planes = _stack_shards()
    answers = []
    for dev in (cuda_device, torch.device("cpu")):
        eng = VariantEngine(BeaconConfig(engine=EngineConfig(
            microbatch_wait_ms=0.0)), device=dev)
        tier = MeshDispatchTier(eng, devices=[dev] * 2)
        try:
            for s in with_planes:
                eng.add_index(s)
            assert tier.warmup() == 2
            telemetry.reset_launch_counts()
            out = []
            for sel in (False, True):
                payload = VariantQueryPayload(
                    dataset_ids=["p", "w"], reference_name="1", start_min=1,
                    start_max=30_000, end_min=1, end_max=1 << 30,
                    alternate_bases="N", requested_granularity="record",
                    include_datasets="HIT", include_samples=True,
                    selected_samples_only=sel,
                    sample_names={"p": ["S1", "S7", "S30"],
                                  "w": ["W3", "W69"]} if sel else {})
                ds = tier.resolve(["p", "w"], payload)
                assert ds == {"p", "w"}
                out.append(tier.search(payload, ds))
            if dev.type == "cuda":
                assert tm.mesh_fused_launches == 4
            answers.append(out)
        finally:
            tier.close()
            eng.close()
    assert answers[0] == answers[1]


# -- the policy plane's device seams ---------------------------------------------


@pytest.fixture
def recorder(monkeypatch):
    """A fresh device flight recorder in place of the process one."""
    rec = telemetry.DeviceFlightRecorder(4096)
    monkeypatch.setattr(telemetry, "flight_recorder", rec)
    return rec


def _policy_engine(device):
    eng = VariantEngine(BeaconConfig(engine=EngineConfig(use_mesh=False)),
                        device=device)
    eng.add_index(synthetic_shard(20_000, n_samples=70, seed=3,
                                  dataset_id="p", with_gt_planes=True))
    eng.add_index(synthetic_shard(20_000, seed=4, dataset_id="w"))
    return eng


@pytest.mark.cuda
def test_recorder_families_equal_kernel_launches(cuda_device, recorder):
    """The flight recorder's families count what the wrappers launch:
    scatter = scatter_match, fused = bisect_query, plane =
    scatter_selected + plane_stats (http_policy_path's gate (f))."""
    eng = _policy_engine(cuda_device)
    try:
        telemetry.reset_launch_counts()
        assert eng.warmup() > 0
        fam = recorder.launches_by_family()
        assert fam.get("scatter", 0) == telemetry.launch_count(sk.KERNEL) > 0
        assert fam.get("fused", 0) + fam.get("fused_l0", 0) == (
            telemetry.launch_count(tk.KERNEL)) > 0
        assert fam.get("plane", 0) == (
            telemetry.launch_count(sk.SELECTED_KERNEL)
            + telemetry.launch_count(pk.KERNEL)) > 0
        snap = recorder.snapshot()
        assert snap["total"] == sum(fam.values())
        assert all(r["warmup"] for r in snap["ring"]["entries"])
        # the scatter kernel's chunk padding reaches the pad counters
        assert snap["padWaste"]["byFamily"]["scatter"] > 0
    finally:
        eng.close()


@pytest.mark.cuda
def test_canary_round_launches_on_the_card(cuda_device):
    """A canary round's probes launch the scatter match kernel (past the
    response cache) and every verdict holds."""
    from sbeacon_tpu_torch.canary import CanaryProber

    eng = _policy_engine(cuda_device)
    try:
        prober = CanaryProber(eng, interval_s=0)
        telemetry.reset_launch_counts()
        got = prober.run_once()
        assert got["registered"] == 4 and got["probes"] == 8
        assert got["mismatches"] == got["failures"] == 0
        assert telemetry.launch_count(sk.KERNEL) == 8
        again = prober.run_once()
        assert again["mismatches"] == 0
        assert telemetry.launch_count(sk.KERNEL) == 16  # no cache hit
    finally:
        eng.close()


@pytest.mark.cuda
def test_first_library_load_is_a_compile(cuda_device, recorder, monkeypatch):
    from sbeacon_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "_libs", {})
    with telemetry.device_warmup_phase():
        _build.load(sk.KERNEL)
    _build.load(pk.KERNEL)
    comp = recorder.compile_snapshot()
    assert [e["key"] for e in comp["entries"]] == [sk.KERNEL, pk.KERNEL]
    assert comp["warmupShapes"] == [sk.KERNEL]
    assert comp["midRequestCompiles"] == 1
    assert all(e["durationMs"] > 0 for e in comp["entries"])


@pytest.mark.cuda
def test_profile_region_holds_the_kernel(index, tmp_path):
    """A kernel launched on another thread inside a ``kernel.launch``
    span, under the process capture (``telemetry._Profiler``, which
    ``SBEACON_PROFILE`` arms): in the exported trace the launch call
    lies inside the span's ``sbeacon.kernel.launch`` range on its
    thread, and the ``scatter_match`` kernel it enqueued runs on the
    card after that call (server_entry's gate)."""
    import json
    import threading

    from sbeacon_tpu_torch.utils import trace

    prof = telemetry._Profiler(str(tmp_path))
    assert prof.start()
    ids, q8 = (torch.from_numpy(x).to(index.device)
               for x in _main_path_slots(index, 6, 100, False, seed=4))

    def launch():
        with trace.span("kernel.launch"):
            sk.scatter_match(index.tiles, ids, q8, T=index.tile, CAP=128,
                             C=2)
            torch.cuda.synchronize()

    t = threading.Thread(target=launch)
    t.start()
    t.join()
    time.sleep(0.05)
    path = prof.stop()
    with open(path) as f:
        evs = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = [e for e in evs if e.get("cat") == "kernel"
               and "scatter_match_kernel" in e["name"]]
    regions = [e for e in evs if e["name"] == "sbeacon.kernel.launch"
               and e.get("cat") in ("cpu_op", "user_annotation")]
    calls = {e["args"]["correlation"]: e for e in evs
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}
    assert kernels and regions

    def holds(r, call):
        return (r.get("pid"), r.get("tid")) == (
            call.get("pid"), call.get("tid")) and r["ts"] <= call["ts"] \
            <= r["ts"] + r.get("dur", 0)

    held = [k for k in kernels
            if (call := calls.get(k.get("args", {}).get("correlation")))
            is not None and any(holds(r, call) for r in regions)
            and k["ts"] >= call["ts"]]
    assert held, (len(kernels), len(regions))
    # the program's span is in the capture log too
    assert "kernel.launch" in {r.name for r in trace.capture_records()}


#: the largest share of a spin-kernel hold an asynchronous launch may
#: take on the host: a hidden wait for the card would take all of it
HOLD_SHARE = 0.5


def _under_hold(call):
    """``call()`` while a spin kernel holds the current stream: returns
    (its result, its host ms, whether an event recorded right after it
    was still pending)."""
    torch.cuda._sleep(timing.HOLD_CYCLES)
    t0 = time.perf_counter()
    pending = call()
    ms = (time.perf_counter() - t0) * 1e3
    after = torch.cuda.Event()
    after.record()
    return pending, ms, not after.query()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fused", "l0", "mesh_plain_owner",
                                  "mesh_plain_sliced", "mesh_planes_owner",
                                  "mesh_planes_sliced"])
def test_async_launch_returns_under_a_held_stream(case, fused, l0_composites,
                                                  fused_meshes):
    """run_queries(async_fetch=True) (J3 on the fused stack and on an L0
    composite) and run_mesh_queries(async_fetch=True) (J6, with and
    without sample masks, then the combine) return while a spin kernel
    still holds the stream: no pageable upload, readback or host fan-in
    waits for the card. Each fetch equals the synchronous answer byte
    for byte, and the handle lets go of its buffers."""
    if case == "fused":
        index, _cpu, shards = fused
        specs, sids = _fused_specs(shards, 24, seed=31)
        run = lambda **kw: tk.run_queries(
            index, encode_queries(specs, shard_ids=sids), window_cap=2048,
            record_cap=256, **kw)
    elif case == "l0":
        index, keys = l0_composites[4]
        specs, sids = l0_tail_specs(index, keys, seed=32)
        run = lambda **kw: tk.run_queries(
            index, encode_queries(specs, shard_ids=sids), window_cap=2048,
            record_cap=256, **kw)
    else:
        _mesh, kind, layout = case.split("_")
        mfi, shards = fused_meshes[(kind, 2)]
        mfi.layout = {"owner": tm.LAYOUT_OWNER,
                      "sliced": tm.LAYOUT_SLICED}[layout]
        specs, sids = _fused_specs(shards, 24, seed=33)
        planes = {}
        if kind == "planes":
            planes = dict(sample_masks=_masks(24, mfi.plane_words, seed=34),
                          mask_counts=np.arange(24) % 2 == 0)
        run = lambda **kw: mfi.run_mesh_queries(
            encode_queries(specs, shard_ids=sids), window_cap=2048,
            record_cap=256, **planes, **kw)
    want = run()  # also warms the allocators and the kernel library
    hold_ms = timing.warm_and_hold(lambda _x: None, [])
    pending, ms, held = _under_hold(lambda: run(async_fetch=True))
    assert held, "the launch waited for the held stream"
    assert ms < HOLD_SHARE * hold_ms, (ms, hold_ms)
    got = pending.fetch()
    for f in ("exists", "call_count", "n_variants", "all_alleles_count",
              "n_matched", "overflow", "rows", "pc_call", "pc_tok",
              "or_words"):
        a, w = getattr(got, f), getattr(want, f)
        assert (a is None) == (w is None), f
        if a is not None:
            assert a.dtype == w.dtype and np.array_equal(a, w), f
    assert pending._out is None
