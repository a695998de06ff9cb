"""Request micro-batcher: concurrent queries share one kernel launch.

Counterpart of ``sbeacon_tpu/serving.py`` (``MicroBatcher`` with its
``_Accumulator`` / ``_LaunchPool``, ``submit`` / ``submit_many``, the
launch stage ``_execute``). The JAX package's separate fetch stage
(``_fetch_batch``, its fetcher pool and the bounded launch/fetch
pipeline) has no counterpart: every kernel's dispatch reads its results
back inside the launch, so ``_execute`` hands them out. A submission may
target shards of a ``FusedDeviceIndex`` (or of the delta tail's L0
index) or of a mesh-sharded ``MeshFusedIndex`` (``shard_id`` /
``shard_ids``): queries for different datasets then share the index's
accumulator and its launch; mesh plane submissions (``sample_masks``)
accumulate apart and each waiter gets its rows of ``pc_call``,
``pc_tok`` and ``or_words`` too.

The serving hooks are the JAX package's: each submission's wait is
bounded by its request deadline (``resilience.current_deadline``)
combined with the batch timeout, and its expiry raises
``DeadlineExceeded`` (504) when the request's deadline lapsed, else
``BatchTimeout`` (503); the leader drops queued entries that expired
and launches nothing for a batch whose entries all expired; a backlog
larger than one batch pops interactive entries before bulk ones (the
lane is the request context's ``lane`` note); the launch hits the
``kernel.launch`` fault point; each request is charged its queue wait
and its share of the launch's time (``telemetry.charge_cost_to``), and
notes its ``batch`` plan stage.

Leader election (no dedicated flusher thread, zero idle cost): the
first request into an empty accumulator becomes the leader, waits up to
``max_wait_ms`` for followers (or until ``max_batch`` arrive), then runs
the whole batch as one ``run_queries_auto`` call and hands each waiter
its row of the results. With ``max_wait_ms`` 0 batches form from the
requests that queue behind an in-flight launch.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass

import numpy as np

from .harness.faults import fault_point
from .ops import run_queries_auto
from .ops.kernel import QueryResults, encode_queries
from .plan import plan_stage
from .resilience import (
    NO_DEADLINE,
    BatchTimeout,
    Deadline,
    DeadlineExceeded,
    current_deadline,
)
from .telemetry import (
    annotate,
    charge_cost_to,
    current_context,
    percentiles,
    request_context,
)
from .utils.trace import span


@dataclass
class _Pending:
    #: the submission's query specs — one for a plain submit, several
    #: for submit_many; the result is the matching row-slice of the
    #: batched QueryResults
    specs: list
    event: threading.Event
    #: per-spec shard ids of a FusedDeviceIndex submission (None for a
    #: single-shard index)
    shard_ids: list | None = None
    #: per-spec sample masks (uint32 [k, W]) and restricted-count
    #: switches ([k] bool) of a mesh-tier plane submission
    sample_masks: object = None
    mask_counts: object = None
    result: object = None
    error: BaseException | None = None
    t_submit: float = 0.0
    #: combined bound (request deadline and batch timeout): when waits end
    deadline: Deadline = NO_DEADLINE
    #: the request deadline alone: decides 504 (the request's) against
    #: 503 (a server-side wedge) when the combined bound expires
    req_deadline: Deadline = NO_DEADLINE
    #: priority lane, from the submitting request context's notes: when
    #: the backlog exceeds one batch, interactive entries ride the next
    #: launch ahead of bulk ones
    lane: str = "interactive"
    #: the submitting request's context (cost attribution; None charges
    #: the unattributed residue)
    ctx: object = None


class _Accumulator:
    """Per-(device-index, caps) accumulation queue."""

    def __init__(self):
        self.lock = threading.Lock()
        self.items: list[_Pending] = []
        self.leader_active = False


class _LaunchPool:
    """Minimal DAEMON-thread work pool for kernel launches.

    Not a ThreadPoolExecutor: its atexit hook joins the (non-daemon)
    workers, so a wedged launch would block interpreter shutdown.
    Workers are created lazily, one per submit up to ``max_workers``.
    """

    def __init__(self, max_workers: int, name: str):
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._max = max_workers
        self._name = name
        self._lock = threading.Lock()
        self._n_threads = 0
        self._closed = False

    def submit(self, fn, *args) -> threading.Event:
        """Enqueue fn(*args); returns an Event set when it finishes.
        Raises after close()."""
        done = threading.Event()
        with self._lock:
            if self._closed:
                raise RuntimeError("launch pool is closed")
            self._q.put((fn, args, done))
            if self._n_threads < self._max:
                self._n_threads += 1
                threading.Thread(
                    target=self._worker,
                    name=f"{self._name}_{self._n_threads}",
                    daemon=True,
                ).start()
        return done

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:  # close() poison pill
                return
            fn, args, done = item
            try:
                fn(*args)
            finally:
                done.set()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            n = self._n_threads
        for _ in range(n):
            self._q.put(None)

    def depth(self) -> dict:
        """{'threads': spawned workers, 'queued': tasks not yet picked
        up}."""
        with self._lock:
            return {"threads": self._n_threads, "queued": self._q.qsize()}


class MicroBatcher:
    """Batches kernel launches per device index.

    ``submit`` blocks until the caller's query has executed (alone after
    ``max_wait_ms`` of quiet, or sooner as part of a fuller batch) and
    returns that query's row of the :class:`QueryResults`.
    """

    #: a queued bulk entry older than this is no longer sorted behind
    #: newly-arrived interactive entries: lane precedence must not become
    #: starvation when the backlog stays above one batch
    BULK_SORT_STARVATION_MS = 500.0

    def __init__(
        self,
        *,
        max_batch: int = 512,
        max_wait_ms: float = 2.0,
        default_timeout_s: float | None = None,
        timing_window: int = 65536,
    ):
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        # upper bound on any submit's wait for its kernel launch;
        # None = unbounded
        self.default_timeout_s = default_timeout_s
        self._stats_lock = threading.Lock()
        # {submissions_per_launch: n_launches}
        self._batch_hist: dict[int, int] = {}
        # {specs_per_launch: n_launches}: differs from _batch_hist when
        # multi-dataset submissions (one submission, k specs) ride along
        self._fused_hist: dict[int, int] = {}
        self._n_submits = 0
        self._n_specs = 0
        # submits whose request deadline lapsed before their launch, and
        # those that timed out on the batch bound alone
        self._n_expired = 0
        self._n_timeouts = 0
        # per-request decomposition: queue wait (submit -> launch),
        # exec (launch -> results), and per-launch encode / launch
        # stages, over bounded rings
        self._wait_ms: deque = deque(maxlen=timing_window)
        self._exec_ms: deque = deque(maxlen=timing_window)
        self._encode_ms: deque = deque(maxlen=timing_window)
        self._launch_ms: deque = deque(maxlen=timing_window)
        # the stage histogram (batcher.stage_ms), once register_metrics
        # wired it
        self._stage_hist = None
        # weak-keyed by the device index so accumulators die with it
        self._accums: "weakref.WeakKeyDictionary[object, dict]" = (
            weakref.WeakKeyDictionary()
        )
        self._lock = threading.Lock()
        # launches run on this pool, not on the leader's thread, so the
        # leader's wait for its batch is bounded like a follower's
        self._launcher = _LaunchPool(16, "kernel-launch")

    def _accum(self, dindex, caps: tuple) -> _Accumulator:
        with self._lock:
            by_caps = self._accums.get(dindex)
            if by_caps is None:
                by_caps = {}
                self._accums[dindex] = by_caps
            acc = by_caps.get(caps)
            if acc is None:
                acc = by_caps[caps] = _Accumulator()
            return acc

    def submit(
        self,
        dindex,
        spec,
        *,
        window_cap: int,
        record_cap: int,
        timeout_s: float | None = None,
        shard_id: int | None = None,
    ):
        """This one query's row of the batched QueryResults.
        ``shard_id`` targets the query at one shard segment of a
        FusedDeviceIndex. The wait is bounded by the tightest of
        ``timeout_s``, the batcher's ``default_timeout_s`` and the
        caller thread's request deadline."""
        return self.submit_many(
            dindex,
            [spec],
            window_cap=window_cap,
            record_cap=record_cap,
            timeout_s=timeout_s,
            shard_ids=None if shard_id is None else [shard_id],
        )

    def submit_many(
        self,
        dindex,
        specs: list,
        *,
        window_cap: int,
        record_cap: int,
        timeout_s: float | None = None,
        shard_ids: list | None = None,
        sample_masks=None,
        mask_counts=None,
    ):
        """One submission of several specs (a k-dataset query against a
        FusedDeviceIndex, ``shard_ids`` naming each spec's shard): all
        ride the same batch and so the same launch; the returned
        QueryResults carries one row per spec in order. Waiting and
        expiry are :meth:`submit`'s: the submission is one queue entry.

        ``sample_masks`` (+ ``mask_counts``) target the mesh tier's plane
        reduction; masked submissions accumulate apart from match-only
        ones (the accumulator key carries ``"planes"``), so each shape
        coalesces with its own kind and a match-only batch never pays
        the plane reduction."""
        caps = (
            (window_cap, record_cap)
            if sample_masks is None
            else (window_cap, record_cap, "planes")
        )
        acc = self._accum(dindex, caps)
        req_deadline = current_deadline()
        deadline = req_deadline.combine(
            timeout_s if timeout_s is not None else self.default_timeout_s
        )
        ctx = current_context()
        lane = (ctx.notes.get("lane") if ctx is not None else None) or (
            "interactive"
        )
        me = _Pending(
            specs=list(specs),
            event=threading.Event(),
            shard_ids=None if shard_ids is None else list(shard_ids),
            sample_masks=sample_masks,
            mask_counts=mask_counts,
            t_submit=time.perf_counter(),
            deadline=deadline,
            req_deadline=req_deadline,
            lane=lane,
            ctx=ctx,
        )
        with self._stats_lock:
            self._n_submits += 1
            self._n_specs += len(me.specs)
        with acc.lock:
            acc.items.append(me)
            lead = not acc.leader_active
            acc.leader_active = True

        if lead:
            self._lead(acc, dindex, window_cap, record_cap, me, req_deadline)
        me.event.wait(deadline.remaining())
        if not me.event.is_set():
            # still queued: withdraw so a later launch does not run a
            # query nobody waits for; already in a launched batch: its
            # result lands on an entry nobody reads
            with acc.lock:
                try:
                    acc.items.remove(me)
                except ValueError:
                    pass
                timed_out = not me.event.is_set()
            if timed_out:
                raise self._timeout_error(req_deadline)
        if me.error is not None:
            raise me.error
        batch_ms = round((time.perf_counter() - me.t_submit) * 1e3, 2)
        annotate(batch_ms=batch_ms, batch_index=type(dindex).__name__)
        plan_stage("batch", decision=type(dindex).__name__, batch_ms=batch_ms)
        return me.result

    def _lead(self, acc, dindex, window_cap, record_cap, me, req_deadline):
        # leadership must not stay claimed if the leader dies with
        # anything _serve does not handle: queued followers would wait
        # out their full bounds
        try:
            sleeper = threading.Event()  # timed wait without busy-looping
            waited = 0.0
            step = self.max_wait_s / 4 if self.max_wait_s > 0 else 0
            while waited < self.max_wait_s:
                with acc.lock:
                    if len(acc.items) >= self.max_batch:
                        break
                sleeper.wait(step)
                waited += step
            self._serve(acc, dindex, window_cap, record_cap, me, req_deadline)
        except (BatchTimeout, DeadlineExceeded):
            raise  # the leader's own bound: the batch stays live
        except BaseException as e:
            self._fail_queued(acc, e)
            raise

    def _fail_queued(self, acc: _Accumulator, e: BaseException) -> None:
        """Release leadership and fail everything still queued."""
        with acc.lock:
            acc.leader_active = False
            orphans, acc.items = acc.items, []
        for p in orphans:
            if not p.event.is_set():
                p.error = e
                p.event.set()

    def _pop_batch(self, acc, me):
        """Under ``acc.lock``: the next batch, interactive entries ahead
        of (young) bulk ones, capped by flattened spec count; returns
        (batch, more)."""
        if len(acc.items) > 1:
            # the leading request's own entry stays first: it rides the
            # first pop
            head = 1 if me is not None and acc.items[0] is me else 0
            tail = acc.items[head:]
            if any(p.lane == "bulk" for p in tail) and any(
                p.lane != "bulk" for p in tail
            ):
                now = time.perf_counter()
                exempt_s = self.BULK_SORT_STARVATION_MS / 1e3
                tail.sort(
                    key=lambda p: p.lane == "bulk"
                    and now - p.t_submit < exempt_s
                )
                acc.items[head:] = tail
        # a single oversized submission still goes alone
        n_specs = n_take = 0
        for p in acc.items:
            if n_take and n_specs + len(p.specs) > self.max_batch:
                break
            n_take += 1
            n_specs += len(p.specs)
            if n_take >= self.max_batch:
                break
        batch = acc.items[:n_take]
        acc.items = acc.items[n_take:]
        more = bool(acc.items)
        if not more:
            acc.leader_active = False
        return batch, more

    def _serve(self, acc, dindex, window_cap, record_cap, me, req_deadline):
        """The leadership loop: pop a batch, drop its expired entries,
        launch the rest, wait bounded. ``me`` is the leading request's
        entry (None for a background drainer): once its answer is in,
        remaining backlog passes to a transient daemon drainer and the
        request returns."""
        while True:
            if me is not None and me.event.is_set():
                self._handoff_or_release(acc, dindex, window_cap, record_cap)
                return
            batch: list[_Pending] = []
            try:
                with acc.lock:
                    batch, more = self._pop_batch(acc, me)
                if not batch:
                    return
                # an entry that expired while queued takes no kernel
                # lane, and a batch whose entries all expired launches
                # nothing
                live = []
                for p in batch:
                    if p.deadline.expired():
                        p.error = self._timeout_error(p.req_deadline)
                        p.event.set()
                    else:
                        live.append(p)
            except BaseException as e:
                for p in batch:
                    if not p.event.is_set():
                        p.error = e
                        p.event.set()
                raise
            if me is not None and me.event.is_set() and live:
                # our own entry expired in the filter: answer at once and
                # push the live remainder back for a drainer
                with acc.lock:
                    acc.items = live + acc.items
                    spawn = more or not acc.leader_active
                    if spawn:
                        acc.leader_active = True
                if spawn:
                    threading.Thread(
                        target=self._drain,
                        args=(acc, dindex, window_cap, record_cap),
                        name="batch-drain",
                        daemon=True,
                    ).start()
                return
            if live:
                bound = (
                    me.deadline.remaining()
                    if me is not None and not me.event.is_set()
                    else self.default_timeout_s
                )
                try:
                    done = self._launcher.submit(
                        self._run_batch, live, dindex, window_cap, record_cap,
                    )
                except BaseException as e:
                    # launcher closed mid-shutdown: the popped batch never
                    # reached _run_batch
                    for p in live:
                        if not p.event.is_set():
                            p.error = e
                            p.event.set()
                    raise
                if not done.wait(bound):
                    # the launch may still complete and deliver; only this
                    # serving loop gives up, handing held leadership on
                    if more:
                        self._handoff_or_release(
                            acc, dindex, window_cap, record_cap
                        )
                    if me is None or me.event.is_set():
                        return
                    raise self._timeout_error(req_deadline)
                if me is not None:
                    # the leading request rode the first pop: its result
                    # is in
                    if more:
                        self._handoff_or_release(
                            acc, dindex, window_cap, record_cap
                        )
                    return
            if not more:
                return

    def _handoff_or_release(self, acc, dindex, window_cap, record_cap):
        """Pass held leadership to a transient daemon drainer when
        backlog remains, else release it — atomically, so no window
        exists in which a new submit would elect a second leader."""
        with acc.lock:
            handoff = bool(acc.items)
            if not handoff:
                acc.leader_active = False
        if handoff:
            threading.Thread(
                target=self._drain,
                args=(acc, dindex, window_cap, record_cap),
                name="batch-drain",
                daemon=True,
            ).start()

    def _drain(self, acc, dindex, window_cap, record_cap) -> None:
        """Background drainer: continues the leadership loop after the
        electing request returned."""
        try:
            self._serve(acc, dindex, window_cap, record_cap, None, NO_DEADLINE)
        except BaseException as e:  # failsafe: never strand followers
            self._fail_queued(acc, e)

    def _timeout_error(self, req_deadline) -> BaseException:
        """Bounded-wait expiry, one classification for leader and
        follower: the request deadline lapsed -> 504; only the batch
        timeout -> 503 (wedged device or saturated launcher)."""
        if req_deadline.expired():
            with self._stats_lock:
                self._n_expired += 1
            return DeadlineExceeded(
                "request deadline expired waiting for the kernel launch"
            )
        with self._stats_lock:
            self._n_timeouts += 1
        return BatchTimeout(
            "kernel launch did not complete within the submit timeout "
            "(wedged device or saturated launcher)"
        )

    def _run_batch(self, batch, dindex, window_cap, record_cap) -> None:
        """Launcher-thread entry: _execute plus a failsafe so no batch
        member is left without a result or an error."""
        try:
            self._execute(batch, dindex, window_cap, record_cap)
        except BaseException as e:  # failsafe: deliver the error
            for p in batch:
                if not p.event.is_set():
                    p.error = e
                    p.event.set()

    def close(self) -> None:
        """Release the launcher pool."""
        self._launcher.close()

    def timing_summary(self) -> dict:
        """Percentiles over the bounded rings: queue_wait_ms (submit ->
        launch), exec_ms (launch -> results), and the per-launch stages
        encode_ms and launch_ms (window bounds, tier split, the kernel
        launches, the device run, the readback and the row unpacking)."""
        with self._stats_lock:
            return {
                "queue_wait_ms": percentiles(self._wait_ms),
                "exec_ms": percentiles(self._exec_ms),
                "encode_ms": percentiles(self._encode_ms),
                "launch_ms": percentiles(self._launch_ms),
            }

    def occupancy(self) -> dict:
        """{'submits', 'specs', 'launches', 'mean_batch', 'histogram',
        'fused_hist', 'expired', 'timeouts', 'launcher'} cumulative since
        construction; a launch here is one batched ``run_queries_auto``
        call (which may launch the scatter kernel once per tier split)."""
        with self._stats_lock:
            hist = dict(sorted(self._batch_hist.items()))
            launches = sum(hist.values())
            total = sum(k * v for k, v in hist.items())
            out = {
                "submits": self._n_submits,
                "specs": self._n_specs,
                "launches": launches,
                "mean_batch": round(total / launches, 2) if launches else 0.0,
                "histogram": hist,
                "fused_hist": dict(sorted(self._fused_hist.items())),
                "expired": self._n_expired,
                "timeouts": self._n_timeouts,
            }
        out["launcher"] = self._launcher.depth()
        return out

    def register_metrics(self, registry) -> None:
        """Register this batcher's typed instruments: the occupancy and
        timing dicts' contents under their dotted names (the JAX
        package's, less the fetcher pool's, which has no counterpart),
        read through one snapshot cached for 0.25 s per render, and the
        ``batcher.stage_ms`` histogram the launches then observe."""
        snap_lock = threading.Lock()
        snap = {"t": 0.0, "occ": None, "timing": None}

        def snapshot():
            now = time.monotonic()
            with snap_lock:
                if snap["occ"] is None or now - snap["t"] > 0.25:
                    snap["occ"] = self.occupancy()
                    snap["timing"] = self.timing_summary()
                    snap["t"] = now
                return snap["occ"], snap["timing"]

        def occ(*path):
            def collect():
                v = snapshot()[0]
                for part in path:
                    v = v[part]
                return v

            return collect

        def hist(name):
            return lambda: {
                str(k): v for k, v in snapshot()[0][name].items()
            }

        def timing(name):
            return lambda: snapshot()[1][name]

        registry.counter(
            "batcher.submits", "micro-batch submissions", fn=occ("submits")
        )
        registry.counter(
            "batcher.specs", "flattened query specs", fn=occ("specs")
        )
        registry.counter(
            "batcher.launches", "kernel launches", fn=occ("launches")
        )
        registry.gauge(
            "batcher.mean_batch",
            "mean submissions per launch",
            fn=occ("mean_batch"),
        )
        registry.counter(
            "batcher.expired",
            "submits whose request deadline lapsed before launch",
            fn=occ("expired"),
        )
        registry.counter(
            "batcher.timeouts",
            "submits that timed out waiting for a launch",
            fn=occ("timeouts"),
        )
        registry.counter(
            "batcher.histogram",
            "launches by submissions-per-launch",
            label="batch_size",
            fn=hist("histogram"),
        )
        registry.counter(
            "batcher.fused_hist",
            "launches by flattened specs-per-launch",
            label="specs_per_launch",
            fn=hist("fused_hist"),
        )
        registry.gauge(
            "batcher.launcher.threads", fn=occ("launcher", "threads")
        )
        registry.gauge(
            "batcher.launcher.queued", fn=occ("launcher", "queued")
        )
        registry.gauge(
            "batcher.queue_wait_ms",
            "submit -> kernel launch wait quantiles",
            label="quantile",
            fn=timing("queue_wait_ms"),
        )
        registry.gauge(
            "batcher.exec_ms",
            "launch -> results quantiles",
            label="quantile",
            fn=timing("exec_ms"),
        )
        registry.gauge(
            "batcher.encode_ms",
            "host query-encode quantiles",
            label="quantile",
            fn=timing("encode_ms"),
        )
        registry.gauge(
            "batcher.launch_ms",
            "kernel launch + device run + readback quantiles",
            label="quantile",
            fn=timing("launch_ms"),
        )
        self._stage_hist = registry.histogram(
            "batcher.stage_ms",
            "per-stage latency decomposition (batch_wait/encode/launch)",
            label="stage",
        )

    def _execute(self, batch, dindex, window_cap, record_cap):
        """Launcher thread: flatten the batch's specs (and shard ids),
        encode, run ONE ``run_queries_auto`` call (which reads its
        results back before returning) and hand each submission its
        row-slice; a failed launch hands every submission its error."""
        specs: list = []
        offsets: list[int] = []
        for p in batch:
            offsets.append(len(specs))
            specs.extend(p.specs)
        # one accumulator per index: a fused index's submissions all
        # carry shard ids, a single-shard index's none
        shard_ids = None
        if batch and batch[0].shard_ids is not None:
            shard_ids = [s for p in batch for s in p.shard_ids]
        # plane inputs (mesh tier): the accumulator key keeps masked and
        # unmasked submissions apart, so presence on the first entry
        # means presence on all
        planes = {}
        if batch and batch[0].sample_masks is not None:
            planes["sample_masks"] = np.concatenate(
                [np.asarray(p.sample_masks) for p in batch]
            )
            planes["mask_counts"] = np.concatenate([
                np.asarray(
                    p.mask_counts if p.mask_counts is not None
                    else np.zeros(len(p.specs), np.bool_)
                )
                for p in batch
            ])
        t_launch = time.perf_counter()
        stage_hist = self._stage_hist
        with self._stats_lock:
            self._batch_hist[len(batch)] = (
                self._batch_hist.get(len(batch), 0) + 1
            )
            self._fused_hist[len(specs)] = (
                self._fused_hist.get(len(specs), 0) + 1
            )
            for p in batch:
                self._wait_ms.append((t_launch - p.t_submit) * 1e3)
        for p in batch:
            wait_ms = (t_launch - p.t_submit) * 1e3
            if stage_hist is not None:
                stage_hist.observe(wait_ms, label_value="batch_wait")
            charge_cost_to(p.ctx, queue_wait_ms=wait_ms)
        # the first submitter's request context rides the launch thread,
        # so the launch's spans carry its trace id
        lead_ctx = next((p.ctx for p in batch if p.ctx is not None), None)
        try:
            with request_context(lead_ctx), span("serving.microbatch") as sp:
                # chaos site: a raised fault takes the launch-failure
                # path (every waiter gets the error)
                fault_point("kernel.launch")
                enc = encode_queries(specs, shard_ids=shard_ids)
                t_enc = time.perf_counter()
                res = run_queries_auto(
                    dindex, enc, window_cap=window_cap, record_cap=record_cap,
                    **planes,
                )
                sp.note(batch=len(specs))
        except BaseException as e:
            for p in batch:
                p.error = e
                p.event.set()
            return
        t_done = time.perf_counter()
        exec_ms = (t_done - t_launch) * 1e3
        with self._stats_lock:
            self._encode_ms.append((t_enc - t_launch) * 1e3)
            self._launch_ms.append((t_done - t_enc) * 1e3)
            for _ in batch:
                self._exec_ms.append(exec_ms)
        if stage_hist is not None:
            stage_hist.observe((t_enc - t_launch) * 1e3, label_value="encode")
            stage_hist.observe((t_done - t_enc) * 1e3, label_value="launch")
        # the launch's time, pro-rated to each submission by its share of
        # the flattened specs: the shares sum to the launch exactly
        n_specs = len(specs) or 1
        for p, off in zip(batch, offsets):
            sl = slice(off, off + len(p.specs))
            p.result = QueryResults(**{
                f.name: None if getattr(res, f.name) is None
                else getattr(res, f.name)[sl]
                for f in dataclasses.fields(QueryResults)
            })
            charge_cost_to(
                p.ctx, device_us=exec_ms * 1e3 * len(p.specs) / n_specs
            )
            p.event.set()
