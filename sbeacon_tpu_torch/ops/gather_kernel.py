"""Cross-entry combine of per-entry partial blocks for the mesh tier.

Counterpart of ``sbeacon_tpu/ops/gather_kernel.py``
(``gather_partials_portable``, the Pallas ring ``_ring_step_kernel`` /
``gather_partials_tpu``, ``gather_partials``, ``gather_partials_many``).
The mesh-sharded fused index (``parallel.mesh.MeshFusedIndex``) answers
each query on exactly ONE mesh entry, the owner of its dataset shard,
and every other entry contributes zeros; in its combine layouts the
per-entry partial blocks are summed into a block every entry holds.

A mesh here is a list of ``torch.device`` entries, and a partial block
is one int32 tensor per entry. Two implementations behind one call:

- ``ring_gather``: the hand-written CUDA ring (``csrc/ring_gather.cu``):
  n - 1 steps; in each, every entry launches one kernel that reads its
  left neighbour's current block through a device pointer, adds it to
  its own running sum and moves it into a spare buffer, and a CUDA
  event per entry orders each step before the next. The first step
  reads the entry's own partial and writes a fresh accumulator, so the
  inputs are neither copied nor written: a ring of two entries is two
  launches. ``ring_plan`` names the buffers of every launch. Every
  launch adds one to the ``ring_gather`` launch count;
- ``gather_partials_portable``: the plain-PyTorch twin, the int32 sum
  of the blocks (wrapping, like XLA's add).

The implementation follows the tensors' device: CUDA tensors take the
ring (or raise), CPU tensors the twin (the JAX package's ``impl``
argument has no counterpart). Entries on two cards would need
peer access or NCCL, which this package does not set up (its mesh
entries share one card).
"""

from __future__ import annotations

import time

import torch

from ..telemetry import launch_count, record_device_launch
from . import _build

KERNEL = "ring_gather"


def __getattr__(name: str):
    """``ring_gather_launches``: CUDA launches of the ring step kernel
    since the last ``telemetry.reset_launch_counts()``."""
    if name == "ring_gather_launches":
        return launch_count(KERNEL)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound."""
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


def gather_partials_portable(parts) -> torch.Tensor:
    """The twin: the int32 sum of one partial block per mesh entry (the
    JAX package's ``all_gather`` + sum), on the first entry's device."""
    dev = parts[0].device
    total = sum(p.to(dev, torch.int64) for p in parts)
    return _wrap32(total)


def _impl_for(parts) -> str:
    types = {p.device.type for p in parts}
    if types == {"cpu"}:
        return "portable"
    if types == {"cuda"}:
        return "ring"
    raise ValueError(f"partials lie on {sorted(types)}: all cpu or all cuda")


def ring_plan(n: int) -> list[list[tuple]]:
    """The buffers of every launch of an n-entry ring, per step and per
    entry i: ``(src, own, nxt, acc)``, launched as ``acc = own + src``
    and ``nxt = src``. A buffer is ``("part", i)``, entry i's input
    partial, ``("acc", i)``, its result, or ``("buf", k, i)``, the k-th
    of its two spare buffers (the block it holds after a step, read by
    its right neighbour in the next); ``nxt`` is None on the last step.
    Step 0 reads the inputs and writes each ``acc`` out of place; the
    spare buffers alternate, so no step reads a buffer that another
    entry writes in the same step."""
    steps = []
    for s in range(n - 1):
        last = s == n - 2
        row = []
        for i in range(n):
            left = (i - 1) % n
            src = ("part", left) if s == 0 else ("buf", (s - 1) % 2, left)
            own = ("part", i) if s == 0 else ("acc", i)
            nxt = None if last else ("buf", s % 2, i)
            row.append((src, own, nxt, ("acc", i)))
        steps.append(row)
    return steps


def ring_step(src, nxt, acc, own=None) -> int:
    """One entry's launch of one ring step on ``acc``'s device: ``acc =
    own + src`` (``acc += src`` when ``own`` is None or ``acc`` itself)
    and ``nxt = src`` (``nxt`` None on the last step). Every block is a
    contiguous int32 tensor of one size on the card; ``src`` and ``nxt``
    overlap no other. Returns the launch record's sequence number."""
    own = acc if own is None else own
    dev = acc.device
    blocks = [src, own, acc] + ([] if nxt is None else [nxt])
    if any(b.device.type != "cuda" or b.dtype != torch.int32
           or not b.is_contiguous() or b.numel() != acc.numel()
           for b in blocks):
        raise ValueError("ring_step takes contiguous int32 CUDA blocks of "
                         "one size")
    lib = _build.load(KERNEL)
    t0 = time.perf_counter()
    with torch.cuda.device(dev):
        rc = lib.ring_step_launch(
            src.data_ptr(), own.data_ptr(),
            0 if nxt is None else nxt.data_ptr(), acc.data_ptr(),
            acc.numel(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"ring_gather launch failed: CUDA error {rc}")
    return record_device_launch(
        KERNEL, family="mesh", device=str(dev), words=acc.numel(),
        launch_ms=(time.perf_counter() - t0) * 1e3,
    )


def ring_gather(parts) -> list[torch.Tensor]:
    """Every entry's copy of the sum of ``parts`` (one int32 tensor per
    mesh entry, all of one shape): on CUDA tensors the ring of
    ``ring_step`` launches that ``ring_plan`` lays out, on CPU tensors
    the twin (the same sum for every entry). Any other device, or inputs
    the kernel does not take, raise. The inputs are not written."""
    parts = list(parts)
    if _impl_for(parts) == "portable":
        total = gather_partials_portable(parts)
        return [total.to(p.device) for p in parts]
    shape = tuple(parts[0].shape)
    for p in parts:
        if p.dtype != torch.int32 or not p.is_contiguous():
            raise ValueError("ring_gather takes contiguous int32 blocks")
        if tuple(p.shape) != shape:
            raise ValueError(f"block shapes differ: {tuple(p.shape)} != {shape}")
    n = len(parts)
    if n == 1:
        return [parts[0]]
    if not parts[0].numel():
        return [p.clone() for p in parts]
    bufs = {("part", i): p for i, p in enumerate(parts)}

    def buf(key):
        if key not in bufs:  # an accumulator or spare, on its entry
            bufs[key] = torch.empty_like(parts[key[-1]])
        return bufs[key]

    def mark():
        evs = []
        for p in parts:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(p.device))
            evs.append(ev)
        return evs

    done = mark()  # each entry's inputs are ready
    for row in ring_plan(n):
        for i, (src, own, nxt, acc) in enumerate(row):
            # the left neighbour wrote the block read here; the right
            # neighbour read, one step before, the buffer written here
            stream = torch.cuda.current_stream(parts[i].device)
            stream.wait_event(done[(i - 1) % n])
            stream.wait_event(done[(i + 1) % n])
            ring_step(buf(src), None if nxt is None else buf(nxt), buf(acc),
                      own=buf(own))
        done = mark()
    return [bufs[("acc", i)] for i in range(n)]


def gather_partials(parts) -> list[torch.Tensor]:
    """Every entry's copy of the sum of the per-entry partial blocks: the
    ring on CUDA tensors, the twin on CPU tensors."""
    return ring_gather(parts)


def gather_partials_many(xs_per_entry):
    """ONE combined pass over several partial blocks per entry.

    ``xs_per_entry``: per mesh entry, a tuple of int32 blocks sharing
    the leading batch axis (hit rows, masked call and token popcounts,
    sample-hit words). Each entry's blocks are concatenated along the
    last axis, combined in one ring pass (n - 1 steps instead of 4x),
    and split back: returns, per entry, the tuple of summed blocks."""
    xs_per_entry = [tuple(xs) for xs in xs_per_entry]
    if len(xs_per_entry[0]) == 1:
        return [(g,) for g in gather_partials([xs[0] for xs in xs_per_entry])]
    widths = [int(x.shape[-1]) for x in xs_per_entry[0]]
    cats = [torch.cat(xs, dim=-1) for xs in xs_per_entry]
    out = gather_partials(cats)
    return [tuple(torch.split(g, widths, dim=-1)) for g in out]
