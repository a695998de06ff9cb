"""Device time of kernel calls, from CUDA events.

Counterpart of the timing role of the JAX package's device probes
(``sbeacon_tpu/ops/scatter_kernel.py::_probe_one_tier``,
``sbeacon_tpu/ops/plane_kernel.py::device_plane_probe``). Those time a
chain of k launches inside one dispatch and difference two chain
lengths, because the TPU's ``block_until_ready`` returned early over
its transport. A CUDA stream has events that the device itself stamps,
so no chain differencing is needed:

- ``device_ms``: back-to-back calls. A spin kernel (``torch.cuda._sleep``)
  holds the stream while the host enqueues every timed call, so the
  events time the device's execution rather than the host's launch rate;
  the enqueue must end inside the hold, or the time would be host-bound
  and ``HostBoundTiming`` is raised.
- ``cold_device_ms``: the same with a cold L2: a 128 MB memset before
  each call evicts what the calls before it read, and an event pair
  around each call times it alone (its device-side launch included).

Both run only on a CUDA device. ``host_ms`` times a CPU run (the
twins) with the host clock, for a caller that asked for the CPU.
"""

from __future__ import annotations

import time

import numpy as np
import torch

# spin-kernel hold while timed calls are enqueued (about 100 ms at the
# H100's 1.98 GHz boost clock)
HOLD_CYCLES = 200_000_000
FLUSH_BYTES = 128 << 20  # a memset of this evicts the H100's 50 MB L2


class HostBoundTiming(RuntimeError):
    """The host's enqueue outlasted the spin-kernel hold."""


def warm_and_hold(fn, items) -> float:
    """Calls ``fn`` once on every item (allocator, first launch), then
    returns the ms one HOLD_CYCLES spin kernel holds the stream."""
    for it in items:
        fn(it)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(HOLD_CYCLES)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def check_enqueue(enqueue_ms: float, hold_ms: float) -> None:
    if not enqueue_ms < hold_ms:
        raise HostBoundTiming(
            f"enqueue {enqueue_ms:.1f} ms outlasted the {hold_ms:.1f} ms "
            "hold: the timing would be host-bound"
        )


def device_ms(fn, items, reps: int) -> float:
    """Device ms per call of ``fn`` over ``items``, ``reps`` times each,
    back to back behind a spin-kernel hold. Raises ``HostBoundTiming``
    if the enqueue outlasted the hold (as it does when the calls enqueue
    more kernels than a held stream queues)."""
    hold_ms = warm_and_hold(fn, items)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        for it in items:
            fn(it)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    stop.record()
    torch.cuda.synchronize()
    check_enqueue(enqueue_ms, hold_ms)
    return start.elapsed_time(stop) / (reps * len(items))


def cold_device_ms(fn, items, device, reps: int = 1) -> float:
    """Device ms per call of ``fn`` over ``items`` with a cold L2: a
    FLUSH_BYTES memset before each call, an event pair around each call,
    the mean over ``reps`` passes. The spin-kernel hold of ``device_ms``
    keeps the host's enqueue out of the times."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=device)
    hold_ms = warm_and_hold(fn, items)
    events = [
        (torch.cuda.Event(enable_timing=True),
         torch.cuda.Event(enable_timing=True))
        for _ in range(reps * len(items))
    ]
    torch.cuda._sleep(HOLD_CYCLES)
    t0 = time.perf_counter()
    for (start, stop), it in zip(events, list(items) * reps):
        flush.zero_()
        start.record()
        fn(it)
        stop.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    check_enqueue(enqueue_ms, hold_ms)
    return float(np.mean([a.elapsed_time(b) for a, b in events]))


def host_ms(fn, items, reps: int) -> float:
    """Host-clock ms per call of ``fn`` over ``items``, ``reps`` times
    each, after one warm call per item: how the probes time a CPU run."""
    for it in items:
        fn(it)
    t0 = time.perf_counter()
    for _ in range(reps):
        for it in items:
            fn(it)
    return (time.perf_counter() - t0) * 1e3 / (reps * len(items))
