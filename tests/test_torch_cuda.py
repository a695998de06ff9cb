"""The CUDA kernels (scatter match, bisection query) against their
plain-PyTorch twins.

Runs only where a CUDA device is present (marker ``cuda``); elsewhere
every test skips. It imports nothing of the JAX package, so it runs on
a GPU host without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Outputs are integers: kernel and twin must be equal (tolerance 0).
"""

import random

import numpy as np
import pytest
import torch

from sbeacon_tpu_torch.genomics.vcf import VcfRecord
from sbeacon_tpu_torch.index import build_index
from sbeacon_tpu_torch.ops import kernel as tk
from sbeacon_tpu_torch.ops import scatter_kernel as sk
from sbeacon_tpu_torch.ops.kernel import QuerySpec, encode_queries
from sbeacon_tpu_torch.ops.query_pack import pack_q8, window_bounds
from sbeacon_tpu_torch.testing import random_records


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
