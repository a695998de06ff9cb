"""The CUDA scatter match kernel against its plain-PyTorch twin.

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

from sbeacon_tpu_torch.index import build_index
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
