"""Device-resident genotype bit planes and the plane-stats kernel.

Counterpart of ``sbeacon_tpu/ops/plane_kernel.py`` (``sample_mask_words``,
``PlaneDeviceIndex``, ``staged_device_put``, ``plane_row_stats``) with
the XLA program ``_plane_stats`` replaced by the hand-written CUDA
kernel ``csrc/plane_stats.cu``.

- ``PlaneDeviceIndex`` uploads a shard's planes as ``[n, W]`` int32
  tensors on the device the caller names (W = ceil(n_samples/32)
  words, bit s%32 of word s//32 is sample s; the uint32 words travel as
  int32 bit patterns). The three count planes (gt2, tok1, tok2) ride
  along only when the shard has genotype-derived rows at all. Its byte
  count is the card's real ``n_rows * W * 4`` per plane: a CUDA tensor
  has no 128-lane minor-dim padding, unlike XLA's TPU layout.
- ``staged_upload`` copies a plane in row chunks through pinned host
  buffers into slices of ONE preallocated device tensor: no on-device
  concatenate, so the upload never holds twice the plane on the device
  (the JAX upload does, which is why its engine only chunks when twice
  the plane fits the budget).
- ``plane_stats`` is the kernel's wrapper: on a CUDA tensor it launches
  the kernel (or raises), on a CPU tensor it runs the plain-PyTorch
  twin ``plane_stats_reference``. Every CUDA launch adds one to the
  ``plane_stats`` launch count (``plane_stats_launches``).
- ``plane_row_stats`` gathers a row set's plane words, ANDs the
  selected-sample mask and returns per-row popcounts ``[R, 4]`` plus the
  OR of ``gt & mask`` over a caller-chosen row subset: the quantities
  ``engine.materialize_response`` otherwise computes on the host planes.
- ``device_plane_probe`` times the kernel on a row set (the JAX
  package's probe, on CUDA events).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..index.columnar import FLAG, VariantIndexShard
from ..telemetry import launch_count, record_device_launch
from . import _build, timing
from .kernel import _SMEM_MAX

KERNEL = "plane_stats"
# rows of a plane upload go through pinned host buffers of this size
UPLOAD_CHUNK_BYTES = 256 << 20


def __getattr__(name: str):
    """``plane_stats_launches``: CUDA launches of the plane-stats kernel
    since the last ``telemetry.reset_launch_counts()``."""
    if name == "plane_stats_launches":
        return launch_count(KERNEL)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def sample_mask_words(selected_idx, n_words: int) -> np.ndarray:
    """uint32[n_words] bit mask for a selected-sample index list: the
    wire format every plane consumer shares (bit s%32 of word s//32)."""
    mask = np.zeros(n_words, dtype=np.uint32)
    for si in selected_idx:
        mask[si // 32] |= np.uint32(1 << (si % 32))
    return mask


def staged_upload(a: np.ndarray, device, chunk_bytes: int = UPLOAD_CHUNK_BYTES):
    """A 2-D uint32/int32 host array as an int32 tensor on ``device``.

    On a CUDA device with an array larger than one chunk, the rows go in
    chunks through two pinned host buffers into slices of one
    preallocated device tensor: while one chunk's copy runs, the host
    fills the other buffer. The device holds the array once at every
    moment. Otherwise one copy (on the CPU the tensor shares the array's
    memory)."""
    a = np.ascontiguousarray(a).view(np.int32)
    device = torch.device(device)
    if device.type != "cuda" or a.nbytes <= chunk_bytes or a.ndim != 2:
        return torch.from_numpy(a).to(device)
    n, w = a.shape
    rows_per = max(1, int(chunk_bytes // max(1, w * 4)))
    out = torch.empty((n, w), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device)
    bufs = [
        torch.empty((rows_per, w), dtype=torch.int32, pin_memory=True)
        for _ in range(2)
    ]
    done = [None, None]
    for k, i in enumerate(range(0, n, rows_per)):
        j = min(i + rows_per, n)
        b = k % 2
        if done[b] is not None:
            done[b].synchronize()  # the copy out of this buffer ended
        bufs[b][: j - i].numpy()[:] = a[i:j]
        out[i:j].copy_(bufs[b][: j - i], non_blocking=True)
        done[b] = torch.cuda.Event()
        done[b].record(stream)
    stream.synchronize()
    return out


class PlaneDeviceIndex:
    """Device-resident genotype planes of one shard, on ``device``.

    ``gt`` is always uploaded (sample-hit extraction needs it); the three
    count planes ride along only when the shard contains genotype-derived
    rows (any row without AC_INFO/AN_INFO): otherwise the counting path
    never reads them and uploading them would waste device memory."""

    @staticmethod
    def wants_count_planes(shard: VariantIndexShard) -> bool:
        """All three count planes present AND at least one row without
        INFO-sourced AC/AN: one predicate for the constructor and the
        budget estimate."""
        flags = shard.cols["flags"]
        return bool(
            shard.has_count_planes
            and (
                ((flags & FLAG.AC_INFO) == 0).any()
                or ((flags & FLAG.AN_INFO) == 0).any()
            )
        )

    def __init__(self, shard: VariantIndexShard, device):
        if shard.gt_bits is None:
            raise ValueError("shard has no genotype planes")
        self.device = torch.device(device)
        self.n_rows, self.n_words = shard.gt_bits.shape
        self.has_counts = self.wants_count_planes(shard)
        self.gt = staged_upload(shard.gt_bits, self.device)
        if self.has_counts:
            self.gt2 = staged_upload(shard.gt_bits2, self.device)
            self.tok1 = staged_upload(shard.tok_bits1, self.device)
            self.tok2 = staged_upload(shard.tok_bits2, self.device)
        else:
            self.gt2 = self.tok1 = self.tok2 = None

    def nbytes_hbm(self) -> int:
        """Device bytes of the uploaded planes."""
        return self.n_rows * self.n_words * 4 * (4 if self.has_counts else 1)

    @staticmethod
    def estimate_hbm(shard: VariantIndexShard) -> int:
        """Upload-free device-byte estimate for the capacity gate (same
        count-plane predicate as the constructor)."""
        if shard.gt_bits is None:
            return 0
        n, w = shard.gt_bits.shape
        has_counts = PlaneDeviceIndex.wants_count_planes(shard)
        return n * w * 4 * (4 if has_counts else 1)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 bit patterns, as int64 (SWAR, in
    int64 so no step overflows)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise OR over ``dim`` by folding pairwise halves (torch has no
    OR reduction); zeros for an empty dimension."""
    x = x.movedim(dim, 0)
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    while x.shape[0] > 1:
        n = x.shape[0]
        half = n // 2
        folded = x[:half] | x[half : 2 * half]
        x = torch.cat([folded, x[2 * half :]]) if n % 2 else folded
    return x[0]


def plane_stats_reference(
    gt, gt2, tok1, tok2, rows, or_sel, mask, *, with_counts, with_or
):
    """Plain-PyTorch twin of the plane-stats kernel: an op-by-op mirror
    of ``sbeacon_tpu/ops/plane_kernel.py::_plane_stats``.

    ``rows`` int32 [R] (clamped to the plane like an XLA gather),
    ``or_sel`` int32 [R] 0/1, ``mask`` int32 [W]. Returns (counts int32
    [R, 4]: popcounts of gt, gt2, tok1, tok2 under the mask, the last
    three zero without counts; or_words int32 [W]: OR of ``gt & mask``
    over the rows with ``or_sel``, zero without ``with_or``)."""
    m = mask[None, :]
    safe = rows.long().clamp(0, gt.shape[0] - 1)

    def pc(plane):
        return popcount32(plane[safe] & m).sum(dim=1).to(torch.int32)

    g = gt[safe] & m  # [R, W]
    pc_gt = popcount32(g).sum(dim=1).to(torch.int32)
    zero = torch.zeros_like(pc_gt)
    if with_counts:
        cols = [pc_gt, pc(gt2), pc(tok1), pc(tok2)]
    else:
        cols = [pc_gt, zero, zero, zero]
    counts = torch.stack(cols, dim=1)
    if with_or:
        or_words = or_reduce(
            torch.where(or_sel[:, None] != 0, g, torch.zeros_like(g)), 0
        )
    else:
        or_words = torch.zeros((gt.shape[1],), dtype=torch.int32,
                               device=gt.device)
    return counts, or_words


_fold_lock = threading.Lock()
#: (device index, stream) -> [scratch, ticket] of the plane-stats launches
#: on that stream: the blocks' OR words, and the word whose last taker
#: folds them (zeroed here once; each launch leaves it at 0)
_folds: dict = {}


def _fold_buffers(dev, stream: int, words: int):
    """(scratch, ticket) for a plane-stats launch on ``stream`` that
    folds ``words`` words: the stream's buffers, the scratch grown as
    needed. Launches on one stream run in order, so they may share both;
    the caller holds the tensors until its launch is enqueued."""
    key = (dev.index, stream)
    with _fold_lock:
        bufs = _folds.get(key)
        if bufs is None:
            bufs = _folds[key] = [
                torch.empty((0,), dtype=torch.int32, device=dev),
                torch.zeros((1,), dtype=torch.int32, device=dev),
            ]
        if bufs[0].numel() < words:
            bufs[0] = torch.empty((words,), dtype=torch.int32, device=dev)
        return bufs[0], bufs[1]


def plane_stats(
    gt, gt2, tok1, tok2, rows, or_sel, mask, *, with_counts, with_or
):
    """The plane-stats kernel: (counts [R, 4], or_words [W], seq).

    CUDA tensors launch ``csrc/plane_stats.cu`` on the current stream
    (asynchronously) and record the launch, ``seq`` being its launch
    record. CPU tensors run ``plane_stats_reference`` and ``seq`` is
    None. Any other device, or inputs the kernel does not take, raise.
    Without counts the caller passes ``gt`` for the three count
    planes."""
    if gt.device.type == "cpu":
        counts, or_words = plane_stats_reference(
            gt, gt2, tok1, tok2, rows, or_sel, mask,
            with_counts=with_counts, with_or=with_or,
        )
        return counts, or_words, None
    if gt.device.type != "cuda":
        raise ValueError(f"plane_stats runs on cuda or cpu, not {gt.device}")
    dev = gt.device
    n_plane, w = gt.shape
    r = rows.shape[0]
    for name, x, shape in (
        ("gt", gt, (n_plane, w)),
        ("gt2", gt2, (n_plane, w)),
        ("tok1", tok1, (n_plane, w)),
        ("tok2", tok2, (n_plane, w)),
        ("rows", rows, (r,)),
        ("or_sel", or_sel, (r,)),
        ("mask", mask, (w,)),
    ):
        if x.device != dev or x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on {dev}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} shape {tuple(x.shape)} != {shape}")
    if w < 1 or n_plane < 1 or 2 * w * 4 > _SMEM_MAX:
        raise ValueError(
            f"unsupported plane shape [{n_plane}, {w}]: the kernel holds "
            f"the mask and the OR words in shared memory (at most "
            f"{_SMEM_MAX // 8} words)"
        )
    # the launch writes every word of both outputs: no fill before it
    counts = torch.empty((r, 4), dtype=torch.int32, device=dev)
    or_words = torch.empty((w,), dtype=torch.int32, device=dev)
    lib = _build.load(KERNEL)
    t0 = time.perf_counter()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        parts = lib.plane_stats_clusters(r, int(bool(with_counts)), n_sm)
        scratch = ticket = None
        if with_or and parts > 1:
            scratch, ticket = _fold_buffers(dev, stream, parts * w)
        rc = lib.plane_stats_launch(
            gt.data_ptr(),
            gt2.data_ptr(),
            tok1.data_ptr(),
            tok2.data_ptr(),
            rows.data_ptr(),
            or_sel.data_ptr(),
            mask.data_ptr(),
            counts.data_ptr(),
            or_words.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            None if ticket is None else ticket.data_ptr(),
            r,
            w,
            n_plane,
            int(bool(with_counts)),
            int(bool(with_or)),
            n_sm,
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"plane_stats launch failed: CUDA error {rc}")
    planes = 4 if with_counts else 1
    return counts, or_words, record_device_launch(
        KERNEL,
        rows=r,
        words=w,
        with_counts=bool(with_counts),
        with_or=bool(with_or),
        plane_bytes=r * w * 4 * planes,
        launch_ms=(time.perf_counter() - t0) * 1e3,
    )


def plane_row_stats(
    pindex: PlaneDeviceIndex,
    rows: np.ndarray,
    selected_mask_words: np.ndarray | None,
    *,
    or_sel: np.ndarray | None = None,
    with_counts: bool | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Device masked plane reductions for a matched-row set.

    Returns ``(counts[len(rows), 4] int64, or_words[W] uint32)``.
    ``or_sel`` restricts the gt OR-reduction to a row subset (the
    caller's exact ``grp >= k0`` selection); None ORs nothing.
    ``with_counts`` defaults to the plane set's capability. One launch
    at the row set's own size: the JAX package's row tiers and its host
    chunking past 8192 rows pad with rows whose outputs it discards, so
    the outputs are the same."""
    R = len(rows)
    if with_counts is None:
        with_counts = pindex.has_counts
    if R == 0:
        return np.zeros((0, 4), np.int64), np.zeros(pindex.n_words, np.uint32)
    if selected_mask_words is None:
        mask = np.full(pindex.n_words, 0xFFFFFFFF, np.uint32)
    else:
        mask = np.asarray(selected_mask_words, dtype=np.uint32)
    sel = (
        np.zeros(R, np.int32)
        if or_sel is None
        else np.asarray(or_sel, dtype=np.int32)
    )
    dev = pindex.device
    to_dev = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    gt = pindex.gt
    counts, or_words, _seq = plane_stats(
        gt,
        pindex.gt2 if with_counts else gt,
        pindex.tok1 if with_counts else gt,
        pindex.tok2 if with_counts else gt,
        to_dev(np.asarray(rows).astype(np.int32)),
        to_dev(sel),
        to_dev(mask.view(np.int32)),
        with_counts=with_counts,
        with_or=or_sel is not None,
    )
    return (
        counts.cpu().numpy().astype(np.int64),
        or_words.cpu().numpy().view(np.uint32),
    )


def device_plane_probe(
    pindex: PlaneDeviceIndex,
    rows: np.ndarray,
    selected_mask_words: np.ndarray,
    *,
    iters: int = 64,
) -> float:
    """Seconds per plane-stats call on the device, at the row set's own
    size, with the JAX probe's arguments (every row in the OR, counts
    when the plane set has them): ``iters`` back-to-back launches timed
    by CUDA events behind a spin-kernel hold on a CUDA index
    (``ops.timing.device_ms``), the host clock around the twin on a CPU
    index. The JAX package differences two launch chains instead,
    because its transport's ``block_until_ready`` returned early."""
    dev = pindex.device
    to_dev = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    rows_d = to_dev(np.asarray(rows).astype(np.int32))
    sel_d = torch.ones(len(rows), dtype=torch.int32, device=dev)
    mask = np.asarray(selected_mask_words, dtype=np.uint32)
    mask_d = to_dev(mask.view(np.int32))
    gt = pindex.gt
    with_counts = pindex.has_counts
    planes = (
        (gt, pindex.gt2, pindex.tok1, pindex.tok2) if with_counts else (gt,) * 4
    )

    def launch(_item):
        return plane_stats(
            *planes, rows_d, sel_d, mask_d, with_counts=with_counts,
            with_or=True,
        )

    per_call = timing.device_ms if dev.type == "cuda" else timing.host_ms
    return per_call(launch, [None], reps=iters) / 1e3
