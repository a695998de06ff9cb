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
from sbeacon_tpu_torch.parallel import mesh as tm
from sbeacon_tpu_torch.testing import distinct_key_cases, subset_shard
from torch_ingest_corpus import no_thread_leak  # noqa: F401

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


@pytest.mark.parametrize("n_dev", [1, 4, 8])
@pytest.mark.parametrize("name", CORPORA)
def test_mesh_count_matches_jax(name, n_dev):
    """``distinct_count_device(mesh=)`` over a CPU mesh of ``n_dev``
    entries (one partition_keys block and one twin count per entry,
    summed on the first) equals JAX's on a mesh of as many devices and
    the host oracle."""
    j, t = _corpus(name)
    want = jd.distinct_count_device(j, mesh=make_mesh(n_dev)) if j else 0
    mesh = tm.make_mesh(devices=[torch.device("cpu")] * n_dev)
    got = td.distinct_count_device(t, mesh=mesh)
    assert isinstance(got, int)
    assert got == want
    if name != "highbit":
        assert got == _jax_host(name)


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


@pytest.mark.parametrize("n", [0, 1, 2048, 2049, 10 ** 6, 7 * 10 ** 7,
                               3 * 10 ** 8])
def test_bucket_plan_fits_shared_memory(n):
    """Buckets a power of two, no more than the hist and scatter blocks'
    shared memory counts, the fewest whose average fits KEYS_PER_BUCKET
    (itself under the set's limit), every kernel within the opt-in, and
    scratch of one copy of the keys as 32-byte items and three words a
    bucket (no table sized on the keys)."""
    plan = td.bucket_plan(n)
    b = plan["buckets"]
    assert b == 1 << plan["log2_buckets"] and b <= 1 << td.MAX_LOG2_BUCKETS
    assert n <= b * td.KEYS_PER_BUCKET or b == 1 << td.MAX_LOG2_BUCKETS
    assert b == 1 or n > b // 2 * td.KEYS_PER_BUCKET
    assert td.KEYS_PER_BUCKET <= plan["table_limit"] < td.TABLE_SLOTS
    assert plan["pass_smem"] == 4 * b <= td.SMEM_OPT_IN
    assert plan["set_smem"] <= td.SMEM_OPT_IN
    assert 1 <= plan["blocks"] <= td.H100_SMS
    assert n * td.ITEM_BYTES <= plan["scratch_bytes"]
    assert plan["scratch_bytes"] <= n * td.ITEM_BYTES + (1 << 20)


def _mix64(z):
    z = z ^ (z >> np.uint64(30))
    z = z * np.uint64(0xBF58476D1CE4E5B9)
    z = z ^ (z >> np.uint64(27))
    z = z * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _key_hash(keys):
    """The kernel's 64-bit key mix, in numpy."""
    u = keys.view(np.uint32).astype(np.uint64)
    pair = lambda a, b: (u[:, a] << np.uint64(32)) | u[:, b]
    h = _mix64(pair(0, 1) ^ np.uint64(0x9E3779B97F4A7C15))
    h = _mix64(h ^ pair(2, 3))
    return _mix64(h ^ pair(4, 5))


def _bucketed_count_model(keys, log2_buckets, limit):
    """The distinct-count kernel's formulation, one thread at a time:
    real keys to buckets by the top hash bits, then per bucket passes of
    a set that takes at most ``limit`` keys; a key that finds no room is
    deferred, the deferred keys the finished set holds are dropped, the
    rest go round again. Returns (count, passes past each bucket's
    first)."""
    real = keys[keys[:, 0] != PAD]
    with np.errstate(over="ignore"):
        h = _key_hash(real)
    bucket = (h >> np.uint64(64 - log2_buckets) if log2_buckets
              else np.zeros(len(real), np.uint64))
    count = spills = 0
    for b in np.unique(bucket):
        pending = [tuple(k) for k in real[bucket == b]]
        passes = 0
        while pending:
            passes += 1
            table, deferred = set(), []
            for k in pending:
                if k in table:
                    continue
                if len(table) >= limit:
                    deferred.append(k)
                    continue
                table.add(k)
                count += 1
            pending = [k for k in deferred if k not in table]
        spills += passes - 1
    return count, spills


def _excl(a, axis=0):
    return np.cumsum(a, axis=axis) - a


def _scatter_model(keys, log2b, blocks):
    """The kernel's hist, starts and scatter, index for index: per-block
    bucket counts added into the totals, their exclusive scan as the
    starts and the cursors, then every key written where its bucket's
    cursor points (the blocks' keys in turn, as one arrival order the
    cursors' atomics allow). Returns (the keys in bucket order, bucket
    starts, bucket totals)."""
    n = len(keys)
    B = 1 << log2b
    with np.errstate(over="ignore"):
        h = _key_hash(keys)
    bucket = (h >> np.uint64(64 - log2b)).astype(np.int64) if log2b else \
        np.zeros(n, np.int64)
    real = keys[:, 0] != PAD
    chunk = -(-n // blocks) if n else 0
    block = np.arange(n) // max(chunk, 1)
    totals = np.zeros(B, np.int64)
    for g in range(blocks):
        np.add.at(totals, bucket[real & (block == g)], 1)
    starts = _excl(totals)
    out = np.full((n, 6), PAD, np.int32)
    cur = starts.copy()
    for r in np.flatnonzero(real)[::-1]:  # any order of arrival
        out[cur[bucket[r]]] = keys[r]
        cur[bucket[r]] += 1
    assert (cur == starts + totals).all()
    return out, starts, totals


@pytest.mark.parametrize("log2b,blocks", [(0, 1), (3, 2), (9, 3), (12, 5)])
@pytest.mark.parametrize("case", sorted(CRAFTED))
def test_scatter_model_orders_every_key(case, log2b, blocks):
    """The scatter's cursors place every real key exactly once, each
    bucket's keys in its own contiguous region, and the per-bucket
    distinct counts add up to the twin's."""
    keys = CRAFTED[case]
    final, starts, totals = _scatter_model(keys, log2b, blocks)
    n_real = int((keys[:, 0] != PAD).sum())
    assert int(totals.sum()) == n_real
    assert (final[:n_real, 0] != PAD).all() and (final[n_real:, 0] == PAD).all()
    with np.errstate(over="ignore"):
        got_b = (_key_hash(final[:n_real]) >> np.uint64(64 - log2b)).astype(
            np.int64) if log2b else np.zeros(n_real, np.int64)
    want_b = np.repeat(np.arange(1 << log2b), totals)
    np.testing.assert_array_equal(got_b, want_b)
    distinct = sum(_unique_rows(final[s : s + t]) for s, t in zip(starts, totals))
    assert distinct == int(td.distinct_count_reference(torch.from_numpy(keys)))


@pytest.mark.parametrize("log2_buckets,limit", [(0, 1), (2, 7), (6, 3072)])
@pytest.mark.parametrize("case", sorted(CRAFTED))
def test_bucketed_count_model_matches_twin(case, log2_buckets, limit):
    """The kernel's buckets and spilling sets count exactly, whatever
    the set's limit: against the twin and the unique rows."""
    keys = CRAFTED[case]
    got, spills = _bucketed_count_model(keys, log2_buckets, limit)
    want = int(td.distinct_count_reference(torch.from_numpy(keys)))
    assert got == want == _unique_rows(keys)
    if limit == 1 and want > 1:
        assert spills > 0


def test_entry_point_needs_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _j, t = _corpus("three")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        td.distinct_count_device(t)


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        td.distinct_count(torch.zeros((4, 6), dtype=torch.int32,
                                      device="meta"))
