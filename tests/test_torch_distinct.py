"""The port's distinct-variant count held against the JAX package.

The same seeded corpora go through the JAX package (``shard_keys``,
``partition_keys``, ``distinct_count_device`` on a 1-, 4- and 8-device
CPU mesh, the host oracle ``distinct_variant_count``) and the port
(the same functions, ``distinct_count_device(device="cpu")``, where the
kernel wrapper runs its plain-PyTorch twin). Every output is an integer
or an int32 array: the tolerance is 0. The CUDA kernel itself is held
against the twin on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbeacon_tpu.index.columnar import VariantIndexShard as JShard
from sbeacon_tpu.index.columnar import build_index as j_build_index
from sbeacon_tpu.ingest.pipeline import distinct_variant_count as j_host_count
from sbeacon_tpu.parallel import distinct as jd
from sbeacon_tpu.parallel.mesh import make_mesh
from sbeacon_tpu.testing import random_records as j_random_records
from sbeacon_tpu.testing import synthetic_shard as j_synthetic_shard
from sbeacon_tpu_torch import telemetry
from sbeacon_tpu_torch.index import shard_from_reference
from sbeacon_tpu_torch.ingest.pipeline import distinct_variant_count as t_host_count
from sbeacon_tpu_torch.parallel import distinct as td
from sbeacon_tpu_torch.testing import distinct_key_cases, subset_shard

PAD = np.iinfo(np.int32).max
I32_MIN = np.iinfo(np.int32).min


def _record_shards(n_shards=3, n=400, overlap_seed=None):
    """The corpus of tests/test_distinct_device.py: shards of random
    records on chromosomes 1 and 2 (identical shards with
    ``overlap_seed``)."""
    shards = []
    for k in range(n_shards):
        rng = random.Random(k if overlap_seed is None else overlap_seed)
        recs = []
        for chrom in ("1", "2"):
            recs += j_random_records(rng, chrom=chrom, n=n, n_samples=0)
        shards.append(
            j_build_index(recs, dataset_id=f"d{k}", with_genotypes=False)
        )
    return shards


def _as_jax(shard):
    return JShard(**{f.name: getattr(shard, f.name)
                     for f in dataclasses.fields(JShard)})


def _overlap_corpus():
    """A 2e5-row synthetic shard and three seeded row subsets of it (40-70%
    of its rows each): re-submitted sites, the duplication the count
    removes."""
    base = j_synthetic_shard(200_000, seed=11, dataset_id="base")
    t_base = shard_from_reference(base)
    rng = np.random.default_rng(12)
    subs = []
    for k in range(3):
        m = int(base.n_rows * rng.uniform(0.4, 0.7))
        rows = np.sort(rng.choice(base.n_rows, m, replace=False))
        subs.append(_as_jax(subset_shard(t_base, rows, dataset_id=f"sub{k}")))
    return [base] + subs


def _highbit_corpus():
    """Record shards whose FNV columns hold high-bit patterns (INT32_MIN,
    -1, INT32_MAX and bit-flipped hashes), a copy of the first shard
    among them. The hashes no longer match the allele bytes, so the host
    oracle does not apply."""
    out = []
    for s in _record_shards(2, n=300):
        ref = s.cols["ref_hash"] ^ np.int32(I32_MIN)
        alt = s.cols["alt_hash"] ^ np.int32(I32_MIN)
        k = np.arange(s.n_rows) % 7
        alt = np.where(k == 0, -1, alt)
        alt = np.where(k == 1, I32_MIN, alt)
        alt = np.where(k == 2, PAD, alt).astype(np.int32)
        out.append(dataclasses.replace(
            s, cols={**s.cols, "ref_hash": ref, "alt_hash": alt}))
    return out + out[:1]


_MAKERS = {
    "three": lambda: _record_shards(),
    "dup3": lambda: _record_shards(overlap_seed=7),
    "empty": lambda: [],
    "overlap": _overlap_corpus,
    "highbit": _highbit_corpus,
}
CORPORA = sorted(_MAKERS)
_cache: dict = {}


def _corpus(name):
    """(JAX shards, port shards) of a corpus, built once per process."""
    if name not in _cache:
        j = _MAKERS[name]()
        _cache[name] = (j, [shard_from_reference(s) for s in j])
    return _cache[name]


def _jax_host(name):
    """JAX's host oracle of a corpus, counted once per process."""
    key = ("host", name)
    if key not in _cache:
        _cache[key] = j_host_count(_corpus(name)[0])
    return _cache[key]


def _unique_rows(keys):
    real = keys[keys[:, 0] != PAD]
    return len(np.unique(real, axis=0)) if len(real) else 0


@pytest.mark.parametrize("name", CORPORA)
def test_shard_keys_byte_equal(name):
    j, t = _corpus(name)
    want = jd.shard_keys(j)
    got = td.shard_keys(t)
    assert got.dtype == want.dtype == np.int32
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n_blocks", [1, 4, 8])
@pytest.mark.parametrize("name", CORPORA)
def test_partition_keys_byte_equal(name, n_blocks):
    j, t = _corpus(name)
    want = jd.partition_keys(jd.shard_keys(j), n_blocks)
    got = td.partition_keys(td.shard_keys(t), n_blocks)
    assert got.dtype == want.dtype == np.int32
    assert got.shape == want.shape  # blocks, pow2 width, 6
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n_blocks", [1, 4, 8])
@pytest.mark.parametrize("name", CORPORA)
def test_twin_padded_and_unpadded(name, n_blocks):
    """The twin over the unpadded keys, and summed over the padded
    partition_keys blocks, equals JAX's device count on a mesh of as many
    devices as blocks (and the unique rows)."""
    j, t = _corpus(name)
    keys = td.shard_keys(t)
    unpadded = int(td.distinct_count_reference(torch.from_numpy(keys)))
    blocks = td.partition_keys(keys, n_blocks)
    padded = sum(int(td.distinct_count_reference(torch.from_numpy(b)))
                 for b in blocks)
    want = jd.distinct_count_device(j, mesh=make_mesh(n_blocks)) if j else 0
    assert unpadded == padded == want == _unique_rows(keys)


@pytest.mark.parametrize("n_dev", [1, 4, 8])
@pytest.mark.parametrize("name", CORPORA)
def test_device_count_matches_jax(name, n_dev):
    j, t = _corpus(name)
    want = jd.distinct_count_device(j, mesh=make_mesh(n_dev)) if j else 0
    got = td.distinct_count_device(t, device="cpu")
    assert isinstance(got, int)
    assert got == want
    if name != "highbit":
        assert got == _jax_host(name)
    if name == "overlap":  # the row subsets add no key
        assert got == td.distinct_count_device(t[:1], device="cpu")


@pytest.mark.parametrize("max_range_bytes", [None, 48 * 5000])
@pytest.mark.parametrize("name", CORPORA)
def test_host_count_matches_jax(name, max_range_bytes):
    j, t = _corpus(name)
    want = (_jax_host(name) if max_range_bytes is None
            else j_host_count(j, max_range_bytes=max_range_bytes))
    assert t_host_count(t, max_range_bytes=max_range_bytes) == want


CRAFTED = distinct_key_cases()


@pytest.mark.parametrize("case", sorted(CRAFTED))
def test_twin_on_crafted_keys_matches_jax(case):
    """Every key equal, keys differing in one column, high-bit patterns,
    pad rows (only column 0 marks one), 0-1000 keys: the twin equals
    JAX's ``_local_distinct`` on a one-device mesh and a numpy count."""
    keys = CRAFTED[case]
    got = td.distinct_count(torch.from_numpy(keys))
    assert got[1] is None  # a CPU tensor runs the twin, records nothing
    block = jd.partition_keys(keys, 1)
    want = int(jd._compiled_for(make_mesh(1))(jnp.asarray(block)))
    assert int(got[0]) == want == _unique_rows(keys)


def test_cpu_runs_record_no_launch():
    telemetry.reset_launch_counts()
    _j, t = _corpus("three")
    assert td.distinct_count_device(t, device="cpu") > 0
    assert td.distinct_count_launches == 0


def test_empty_needs_no_keys():
    assert td.distinct_count_device([], device="cpu") == 0
    count, seq = td.distinct_count(torch.zeros((0, 6), dtype=torch.int32))
    assert int(count) == 0 and seq is None


@pytest.mark.parametrize("n", [0, 1, 44, 45, 46, 7 * 10 ** 7])
def test_table_slots_hold_the_load(n):
    cap = td.table_slots(n)
    assert cap >= 64 and cap & (cap - 1) == 0
    assert n <= cap * td.MAX_LOAD
    assert cap == 64 or n > cap // 2 * td.MAX_LOAD


def test_entry_point_needs_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _j, t = _corpus("three")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        td.distinct_count_device(t)


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        td.distinct_count(torch.zeros((4, 6), dtype=torch.int32,
                                      device="meta"))
