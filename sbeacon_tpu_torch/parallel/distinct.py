"""The cross-VCF distinct-variant count on the card (duplicateVariantSearch).

Counterpart of ``sbeacon_tpu/parallel/distinct.py`` (``shard_keys``,
``partition_keys``, ``distinct_count_device``) with the XLA program
``_local_distinct`` (lexsort-unique of one key block, psum over the
mesh) replaced by the hand-written CUDA kernel ``csrc/distinct_count.cu``.

The reference counts distinct variants by fanning bp-ranges to lambdas
that insert ``pos + ref_alt`` strings into an ``unordered_set``. Here:

1. host: every shard's rows become fixed-width int32 keys
   (chrom_code, pos, ref_hash, alt_hash, ref_len, alt_len), the 32-bit
   FNV hashes riding as bit patterns (``shard_keys``);
2. device: one kernel launch counts the distinct rows among them
   (``distinct_count``), comparing all six columns.

Keys are hash-exact: a false merge needs two alleles at the same
position with equal lengths and a double FNV collision.
``ingest.pipeline.distinct_variant_count`` byte-verifies duplicate
groups and is the oracle the tests hold this count against.

Without a mesh the keys go up to one device unpadded, at their own
size: a CUDA kernel compiles no shapes, so JAX's pow2 block padding
(which lets it reuse one compiled program) would only move padding.
Over a mesh (``mesh=``, a ``parallel.mesh.Mesh``; its entries may list
one card more than once), ``partition_keys`` splits the keys into one
block per entry, byte for byte the JAX package's layout (equal keys in
one block; the kernel skips the ``_PAD`` rows), each of this process's
entries' blocks is counted by one kernel launch on its device, and the
partial counts fan in through ``parallel.mesh._psum`` (JAX's ``psum``:
summed on the first local entry, then, over a mesh that spans
processes, all-reduced across the world; every process builds every
key and gets the same count).
``shard_keys`` fills one preallocated key matrix column by column; its
bytes, order included, are the JAX package's.

``distinct_count`` is the kernel's wrapper: on a CUDA tensor it launches
the kernel (or raises), on a CPU tensor it runs the plain-PyTorch twin
``distinct_count_reference``. Every CUDA launch adds one to the
``distinct_count`` launch count (``distinct_count_launches``);
``bucket_plan`` is its host-side split of the keys into buckets.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..index.columnar import VariantIndexShard
from ..ops import _build, resolve_device
from ..telemetry import launch_count, note_device_stage, record_device_launch

KERNEL = "distinct_count"
#: sentinel key rows (column 0) that the count leaves out
_PAD = np.iinfo(np.int32).max
#: slots of a count block's shared-memory hash set (``csrc/distinct_count.cu``
#: ``kTableSlots``): a state word and six key words each
TABLE_SLOTS = 4096
SET_SLOT_BYTES = 28
#: distinct keys a bucket's set takes before the rest spill to another
#: pass (below TABLE_SLOTS, so every probe ends)
TABLE_LIMIT = 3072
#: most buckets: a hist block keeps a uint32 per bucket in shared memory
MAX_LOG2_BUCKETS = 15
#: key rows per bucket the plan aims at (at most): under TABLE_LIMIT, so
#: a bucket of distinct keys fits its set
KEYS_PER_BUCKET = 2048
#: threads of a hist block
PASS_THREADS = 1024
#: shared memory one block may opt into on the H100 (227 KB)
SMEM_OPT_IN = 227 * 1024
#: bytes of one bucket-ordered item: the 24-byte key and its 64-bit hash,
#: a whole 32-byte sector
ITEM_BYTES = 32
#: streaming multiprocessors of the H100 SXM: one hist block each
H100_SMS = 132


def __getattr__(name: str):
    """``distinct_count_launches``: CUDA launches of the distinct-count
    kernel since the last ``telemetry.reset_launch_counts()``."""
    if name == "distinct_count_launches":
        return launch_count(KERNEL)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def shard_keys(shards: list[VariantIndexShard]) -> np.ndarray:
    """[n, 6] int32 key matrix over all rows of all shards, in shard and
    row order (the same key the host exact counter groups by): chrom
    code, pos, the ref and alt FNV hashes as bit patterns, ref and alt
    lengths. Byte for byte the JAX package's, filled column by column
    into one allocation (no per-shard stacks and no concatenation); a
    row's chrom code is the last segment of ``chrom_offsets`` that
    starts at or before it."""
    n_total = sum(s.n_rows for s in shards)
    out = np.empty((n_total, 6), np.int32)
    lo = 0
    for s in shards:
        n = s.n_rows
        hi = lo + n
        off = np.asarray(s.chrom_offsets, dtype=np.int64)
        bounds = np.clip(np.concatenate(([0], off, [n])), 0, n)
        out[lo:hi, 0] = np.repeat(
            np.arange(-1, len(off), dtype=np.int32), np.diff(bounds)
        )
        out[lo:hi, 1] = s.cols["pos"]
        out[lo:hi, 2] = s.cols["ref_hash"].astype(np.uint32, copy=False).view(
            np.int32)
        out[lo:hi, 3] = s.cols["alt_hash"].astype(np.uint32, copy=False).view(
            np.int32)
        out[lo:hi, 4] = s.cols["ref_len"]
        out[lo:hi, 5] = s.cols["alt_len"]
        lo = hi
    return out


def partition_keys(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """[n_shards, width, 6] int32 blocks such that EQUAL keys always land
    in the same block, so no duplicate pair straddles two devices.

    Blocks are key-hash buckets (a multiply-xor row mix, bucket
    ``(mix >> 33) % n_shards``, stable order within a bucket); the width
    is the fullest bucket rounded up to a power of two of at least 256,
    and the rest of each block is ``_PAD`` rows. Byte for byte the JAX
    package's layout."""
    n = len(keys)
    if n == 0 or n_shards <= 1:
        order = np.arange(n)
        counts = np.array([n], dtype=np.int64)
        n_shards = max(n_shards, 1)
    else:
        mix = (
            keys[:, 0].astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
            ^ keys[:, 1].astype(np.uint64) * np.uint64(0xC2B2AE3D27D4EB4F)
            ^ keys[:, 2].astype(np.uint64) * np.uint64(0x165667B19E3779F9)
            ^ keys[:, 3].astype(np.uint64) * np.uint64(0x27D4EB2F165667C5)
            ^ keys[:, 4].astype(np.uint64) * np.uint64(0x85EBCA6B)
            ^ keys[:, 5].astype(np.uint64) * np.uint64(0xC2B2AE35)
        )
        # uint16 bucket ids: numpy radix-sorts <= 16-bit integers
        bucket = ((mix >> np.uint64(33)) % np.uint64(n_shards)).astype(
            np.uint16
        )
        order = np.argsort(bucket, kind="stable")
        counts = np.bincount(bucket, minlength=n_shards)
    width = int(counts.max()) if len(counts) else 0
    pad_w = 256
    while pad_w < width:
        pad_w *= 2
    out = np.full((n_shards, pad_w, 6), _PAD, dtype=np.int32)
    start = 0
    for k in range(n_shards):
        c = int(counts[k]) if k < len(counts) else 0
        out[k, :c] = keys[order[start : start + c]]
        start += c
    return out


def distinct_count_reference(keys: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch twin of the distinct-count kernel: the lexsort-unique
    count of ``sbeacon_tpu/parallel/distinct.py::_local_distinct`` for one
    block.

    ``keys`` int32 [m, 6]. Returns a 0-dim int64 tensor: the number of
    distinct rows among the rows whose column 0 is not ``_PAD``. torch
    has no lexsort: six chained stable sorts, last column first, order
    the rows lexicographically; then every row that differs from its
    predecessor starts a new key."""
    m = keys.shape[0]
    if m == 0:
        return torch.zeros((), dtype=torch.int64, device=keys.device)
    order = torch.arange(m, device=keys.device)
    for col in range(5, -1, -1):
        idx = torch.sort(keys[order, col], stable=True).indices
        order = order[idx]
    srt = keys[order]
    real = srt[:, 0] != _PAD
    diff = (srt[1:] != srt[:-1]).any(dim=1)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=keys.device), diff])
    return (first & real).sum()


def bucket_plan(n: int, sms: int = H100_SMS) -> dict:
    """How the distinct-count kernel splits ``n`` key rows: the least
    power-of-two number of buckets (at most ``2**MAX_LOG2_BUCKETS``)
    whose average holds ``KEYS_PER_BUCKET`` rows or fewer, one hist
    block per SM (fewer for a small ``n``), the shared memory the hist
    and the count blocks take, and the device scratch
    (``scratch_shapes``)."""
    log2 = 0
    while log2 < MAX_LOG2_BUCKETS and n > KEYS_PER_BUCKET << log2:
        log2 += 1
    blocks = max(1, min(sms, -(-n // PASS_THREADS)))
    shapes = scratch_shapes(n, log2)
    return {
        "log2_buckets": log2,
        "buckets": 1 << log2,
        "blocks": blocks,
        "table_limit": TABLE_LIMIT,
        "pass_smem": 4 << log2,
        "set_smem": SET_SLOT_BYTES * TABLE_SLOTS,
        "scratch_bytes": 4 * sum(int(np.prod(v)) for v in shapes.values()),
    }


def scratch_shapes(n: int, log2_buckets: int) -> dict:
    """The kernel's int32 scratch, by name, in the order of its C entry
    point: the keys in bucket order as 32-byte items (the key and its
    64-bit hash), and per bucket its write cursor, start and total."""
    b = 1 << log2_buckets
    return {
        "items": (n, ITEM_BYTES // 4),
        "cursors": (b,),
        "starts": (b,),
        "totals": (b,),
    }


def distinct_count(keys: torch.Tensor, *, log2_buckets: int | None = None,
                   table_limit: int = TABLE_LIMIT,
                   spills: torch.Tensor | None = None):
    """The distinct-count kernel: (count, seq), ``count`` a 0-dim int64
    tensor on the keys' device.

    CUDA tensors launch ``csrc/distinct_count.cu`` on the current stream
    (asynchronously: ``count`` is ready when the stream reaches it; four
    kernels behind one C entry point, one launch record) with the
    buckets of ``bucket_plan``, ``seq`` being its launch record.
    ``log2_buckets`` and ``table_limit`` override the plan (fewer
    buckets or a smaller set make buckets spill to further passes);
    ``spills``, a 0-dim int64 tensor on the device, receives the passes
    past each bucket's first. CPU tensors run
    ``distinct_count_reference`` and ``seq`` is None. Any other device,
    or inputs the kernel does not take, raise."""
    if keys.device.type == "cpu":
        return distinct_count_reference(keys), None
    if keys.device.type != "cuda":
        raise ValueError(f"distinct_count runs on cuda or cpu, not {keys.device}")
    if (
        keys.dtype != torch.int32
        or keys.dim() != 2
        or keys.shape[1] != 6
        or not keys.is_contiguous()
        or keys.data_ptr() % 8
    ):
        raise ValueError(
            "keys must be a contiguous, 8-byte aligned int32 [n, 6] tensor"
        )
    dev = keys.device
    n = keys.shape[0]
    if n == 0:
        return torch.zeros((), dtype=torch.int64, device=dev), None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = bucket_plan(n, sms)
    log2 = plan["log2_buckets"] if log2_buckets is None else int(log2_buckets)
    scratch = {k: torch.empty(v, dtype=torch.int32, device=dev)
               for k, v in scratch_shapes(n, log2).items()}
    out = torch.empty(2, dtype=torch.int64, device=dev)
    if spills is None:
        spills = out[1]
    elif spills.device != dev or spills.dtype != torch.int64:
        raise ValueError("spills must be an int64 tensor on the keys' device")
    lib = _build.load(KERNEL)
    t0 = time.perf_counter()
    with torch.cuda.device(dev):
        rc = lib.distinct_count_launch(
            keys.data_ptr(), n, *(t.data_ptr() for t in scratch.values()),
            log2, plan["blocks"], int(table_limit), out.data_ptr(),
            spills.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"distinct_count launch failed: CUDA error {rc}")
    seq = record_device_launch(
        KERNEL,
        family="distinct",
        device=str(dev),
        rows=n,
        buckets=1 << log2,
        launch_ms=(time.perf_counter() - t0) * 1e3,
    )
    return out[0], seq


def distinct_count_device(shards: list[VariantIndexShard], *, mesh=None,
                          device=None) -> int:
    """Distinct (contig, pos, ref, alt) across shards, counted on the
    card (default) or, with ``device="cpu"``, by the twin on the CPU; or,
    with ``mesh`` (a ``parallel.mesh.Mesh``), over its entries: one
    ``partition_keys`` block per entry and one kernel launch per local
    entry, the partial counts through ``parallel.mesh._psum``
    (``device`` is then not read). Over a mesh that spans processes,
    every process calls this with the same shards.

    The keys are built on the host and copied to the device(s). The
    launch records carry the stage times: ``keys_ms`` (host keys),
    ``upload_ms`` (host to device, with the mesh's partition) and
    ``count_ms`` (first launch to the result on the host)."""
    t0 = time.perf_counter()
    keys = shard_keys(shards)
    if len(keys) == 0:
        return 0
    t1 = time.perf_counter()
    from .mesh import _device_key, _psum

    if mesh is None:
        dev = resolve_device(device)
        parts = [torch.from_numpy(keys).to(dev)]
    else:
        blocks = partition_keys(keys, mesh.size)
        parts = [torch.from_numpy(blocks[g]).to(mesh.devices[g])
                 for g in mesh.local_entries()]
    for d in {_device_key(p.device): p.device for p in parts}.values():
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    t2 = time.perf_counter()
    counts, seqs = zip(*(distinct_count(p) for p in parts))
    total = (int(counts[0]) if mesh is None
             else int(_psum(list(counts), mesh)))
    stages = dict(
        keys_ms=(t1 - t0) * 1e3,
        upload_ms=(t2 - t1) * 1e3,
        count_ms=(time.perf_counter() - t2) * 1e3,
    )
    for seq in seqs:
        note_device_stage(seq, entries=len(parts), **stages)
    return total
