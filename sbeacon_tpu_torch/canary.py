"""Known-answer canary prober: active verification of the data plane.

Counterpart of ``sbeacon_tpu/canary.py``, all of it: ``CanaryProbe``,
``_probes_for`` and ``CanaryProber``. Every load leaves the engine able
to name one row that MUST exist (the known-hit bracket) and one
coordinate range that MUST be empty (the known-miss bracket, beyond the
dataset's coordinate ceiling): ``VariantEngine.canary_brackets``.

:class:`CanaryProber` registers those expected-answer probes from the
serving snapshot (re-synced whenever the index fingerprint changes) and
exercises each probe across query shapes (boolean, count) and dispatch
paths: ``engine`` (``engine.search``: whatever serves — on the card the
scatter match kernel for one dataset, with ``no_response_cache=True``),
``local`` and ``replica:<url>`` when the engine has those halves (a
fleet coordinator, ``parallel.dispatch.DistributedEngine``: its local
engine, and ``call_replica`` on each replica of the probe's dataset).

Each probe asserts **correctness** (``exists`` matches the expectation),
**freshness** (the hit probe targets the newest published row) and
**latency** (probe time under the configured bound). A probe that
raises counts as a failure (``canary.failures``): it is never answered
from the host. Probes run under a synthetic ``canary`` request context:
the route is in ``slo.PROBE_ROUTE_LABELS``, so canary traffic never
consumes an SLO error budget, and its cost vector is dropped, so it
never lands in a tenant's cost table. Its launches go through the same
kernel wrappers as serving launches, so the launch counts and
``/device/status`` see them.

Stdlib only, and engine-shape agnostic (every engine access is
getattr-guarded).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time

from .payloads import VariantQueryPayload
from .telemetry import RequestContext, publish_event, request_context

log = logging.getLogger(__name__)

#: the prober's synthetic route label — a member of
#: ``slo.PROBE_ROUTE_LABELS``, so anything recording it treats it as
#: probe traffic (budget- and cost-excluded)
CANARY_ROUTE = "canary"

#: a known-miss bracket starts this far beyond the dataset's observed
#: coordinate ceiling (new rows land the probes re-derive: any publish
#: changes the fingerprint, which re-syncs the probe set)
MISS_GAP = 1_000


@dataclasses.dataclass(frozen=True)
class CanaryProbe:
    """One registered expected-answer probe."""

    probe_id: str
    dataset_id: str
    kind: str  # "hit" | "miss"
    payload: VariantQueryPayload
    expect_exists: bool


def _probes_for(dataset_id: str, bracket: dict) -> list[CanaryProbe]:
    """The (known-hit, known-miss) probe pair for one dataset's
    bracket source (``VariantEngine.canary_brackets`` entry). A
    bracket with no plain-allele row carries no ``pos``/``alt`` — the
    dataset gets the known-miss probe only (a symbolic-alt hit probe
    would be a standing false alarm)."""
    chrom = bracket["chrom"]
    max_end = int(bracket["maxEnd"])
    end_max = max_end + 1_000_000
    probes = []
    if "pos" in bracket:
        pos = int(bracket["pos"])
        hit = VariantQueryPayload(
            dataset_ids=[dataset_id],
            reference_name=chrom,
            start_min=pos,
            start_max=pos,
            end_min=1,
            end_max=end_max,
            alternate_bases=bracket["alt"],
            requested_granularity="boolean",
            # freshness contract: the probe must read the LIVE data
            # plane — a warm cached answer would mask silent corruption
            no_response_cache=True,
            query_id=f"canary-hit-{dataset_id}",
        )
        probes.append(
            CanaryProbe(f"{dataset_id}:hit", dataset_id, "hit", hit, True)
        )
    miss = VariantQueryPayload(
        dataset_ids=[dataset_id],
        reference_name=chrom,
        start_min=max_end + MISS_GAP,
        start_max=max_end + 2 * MISS_GAP,
        end_min=1,
        end_max=end_max + 2 * MISS_GAP,
        alternate_bases="N",
        requested_granularity="boolean",
        no_response_cache=True,
        query_id=f"canary-miss-{dataset_id}",
    )
    probes.append(
        CanaryProbe(f"{dataset_id}:miss", dataset_id, "miss", miss, False)
    )
    return probes


class CanaryProber:
    """The background known-answer prober.

    ``run_once()`` is the whole engine (the interval thread just calls
    it): sync the probe set against the serving snapshot, then run
    every probe x shape x path under a ``canary`` request context and
    judge the answers. All state is lock-guarded; ``status()`` renders
    the ``/debug/status`` section and ``register_metrics`` the
    ``canary.*`` series. The thread waits one full interval BEFORE the
    first round, so short-lived processes never probe at all.
    """

    #: query shapes each probe exercises per round
    SHAPES = ("boolean", "count")
    #: mismatched probe ids retained for the status rollup
    KEEP_MISMATCHED = 16

    def __init__(
        self,
        engine,
        *,
        interval_s: float = 30.0,
        enabled: bool = True,
        latency_ms: float = 1000.0,
        clock=time.monotonic,
        plan_store=None,
    ):
        self.engine = engine
        self.interval_s = float(interval_s)
        self.enabled = bool(enabled)
        self.latency_ms = float(latency_ms)
        # execution-plan fold (plan.py): each probe's stage trail is
        # observed under a bounded synthetic query shape, and the
        # round loop rolls the sentinel's observation window — drift
        # detection works on a coordinator with zero organic traffic
        self.plan_store = plan_store
        self._clock = clock
        self._lock = threading.Lock()
        self._probes: list[CanaryProbe] = []
        self._synced_fp: str | None = None
        # lifetime counters (the canary.* series)
        self._runs = 0
        self._probe_count = 0
        self._mismatches = 0
        self._failures = 0
        self._slow = 0
        self._last: dict = {}
        self._last_run: float | None = None
        self._mismatched: list[str] = []
        self._closed = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Arm the interval thread (no-op when disabled, interval <= 0,
        or already running)."""
        if not self.enabled or self.interval_s <= 0:
            return
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._thread = threading.Thread(
                target=self._loop, name="canary-prober", daemon=True
            )
        self._thread.start()

    def _loop(self) -> None:
        # first wait BEFORE the first round: construction must not put
        # probe traffic on a process that serves for less than one
        # interval (tests, short CLIs)
        while not self._closed.wait(self.interval_s):
            try:
                self.run_once()
            except Exception:  # the prober must never die quietly
                log.exception("canary probe round failed")

    def close(self) -> None:
        self._closed.set()
        t = self._thread
        if t is not None:
            t.join(timeout=1.0)

    # -- probe registration --------------------------------------------------

    def sync_probes(self) -> int:
        """(Re)derive the probe set from the serving snapshot when the
        index identity changed — registration at ingest time, observed
        rather than hooked: any publish bumps the fingerprint, and the
        next round (or the next explicit sync) re-registers. Returns
        the registered probe count."""
        local = getattr(self.engine, "local", None) or self.engine
        brackets_fn = getattr(local, "canary_brackets", None)
        fp_fn = getattr(local, "index_fingerprint", None)
        if brackets_fn is None or fp_fn is None:
            return 0
        fp = fp_fn()
        with self._lock:
            if fp == self._synced_fp:
                return len(self._probes)
        probes: list[CanaryProbe] = []
        for ds, bracket in sorted(brackets_fn().items()):
            probes.extend(_probes_for(ds, bracket))
        with self._lock:
            self._probes = probes
            self._synced_fp = fp
        if probes:
            publish_event(
                "canary.registered",
                probes=len(probes),
                datasets=len({p.dataset_id for p in probes}),
            )
        return len(probes)

    # -- the probe round -----------------------------------------------------

    def _paths(self, probe: CanaryProbe) -> list[tuple[str, object]]:
        """(name, callable) per dispatch path this probe exercises."""
        out: list[tuple[str, object]] = [
            ("engine", self.engine.search)
        ]
        local = getattr(self.engine, "local", None)
        if local is not None:
            out.append(("local", local.search))
        router = getattr(self.engine, "router", None)
        call = getattr(self.engine, "call_replica", None)
        if router is not None and call is not None:
            for url in router.replicas(probe.dataset_id):
                out.append(
                    (f"replica:{url}", lambda p, u=url: call(u, p))
                )
        return out

    def run_once(self) -> dict:
        """One full probe round; returns (and retains) its summary."""
        self.sync_probes()
        with self._lock:
            probes = list(self._probes)
        ran = mism = fail = slow = 0
        mismatched: list[str] = []
        t_round = self._clock()
        for probe in probes:
            for shape in self.SHAPES:
                pay = dataclasses.replace(
                    probe.payload, requested_granularity=shape
                )
                for path_name, fn in self._paths(probe):
                    ctx = RequestContext(route=CANARY_ROUTE)
                    t0 = time.perf_counter()
                    try:
                        with request_context(ctx):
                            responses = fn(pay)
                    except Exception as e:
                        ran += 1
                        fail += 1
                        publish_event(
                            "canary.failure",
                            probe=probe.probe_id,
                            path=path_name,
                            shape=shape,
                            error=f"{type(e).__name__}: {e}"[:200],
                        )
                        continue
                    elapsed_ms = (time.perf_counter() - t0) * 1e3
                    exists = any(
                        getattr(r, "exists", False) for r in responses
                    )
                    ran += 1
                    if self.plan_store is not None and ctx.plan:
                        # shape x path, NOT per probe id: the same
                        # known-answer query must produce the same
                        # plan, so every probe of a shape folds into
                        # one bounded aggregate whose dominant-plan
                        # flip IS the drift signal
                        self.plan_store.observe(
                            f"canary:{shape}:{path_name}",
                            ctx.plan,
                            trace_id=ctx.trace_id,
                        )
                    if exists != probe.expect_exists:
                        mism += 1
                        label = f"{probe.probe_id}:{shape}@{path_name}"
                        mismatched.append(label)
                        publish_event(
                            "canary.mismatch",
                            probe=probe.probe_id,
                            dataset=probe.dataset_id,
                            path=path_name,
                            shape=shape,
                            expected=probe.expect_exists,
                            got=exists,
                        )
                        log.warning(
                            "canary mismatch: probe %s via %s (%s) "
                            "expected exists=%s got %s",
                            probe.probe_id,
                            path_name,
                            shape,
                            probe.expect_exists,
                            exists,
                        )
                    elif elapsed_ms > self.latency_ms:
                        slow += 1
        if self.plan_store is not None:
            # close the sentinel's observation window at round
            # granularity: a dominant-shape flip seeded this round is
            # journaled before the round's summary lands
            self.plan_store.roll_window()
        summary = {
            "probes": ran,
            "mismatches": mism,
            "failures": fail,
            "slowProbes": slow,
            "registered": len(probes),
            "mismatched": mismatched[: self.KEEP_MISMATCHED],
        }
        with self._lock:
            self._runs += 1
            self._probe_count += ran
            self._mismatches += mism
            self._failures += fail
            self._slow += slow
            self._last = summary
            self._last_run = t_round
            self._mismatched = summary["mismatched"]
        return summary

    # -- surfaces ------------------------------------------------------------

    def counters(self) -> dict:
        with self._lock:
            return {
                "probes": self._probe_count,
                "mismatches": self._mismatches,
                "failures": self._failures,
                "slow": self._slow,
            }

    def status(self) -> dict:
        """The ``/debug/status`` ``canary`` section."""
        with self._lock:
            last_run = self._last_run
            doc = {
                "enabled": self.enabled,
                "intervalS": self.interval_s,
                "latencyBoundMs": self.latency_ms,
                "registeredProbes": len(self._probes),
                "runs": self._runs,
                "probes": self._probe_count,
                "mismatches": self._mismatches,
                "failures": self._failures,
                "slowProbes": self._slow,
                "mismatched": list(self._mismatched),
                "lastRun": dict(self._last) if self._last else None,
            }
        doc["lastRunAgeS"] = (
            None
            if last_run is None
            else round(self._clock() - last_run, 1)
        )
        return doc

    def register_metrics(self, registry) -> None:
        """The ``canary.*`` series (callback-backed off the lifetime
        counters — registered even when disabled, catalogue-stable)."""
        registry.counter(
            "canary.probes",
            "known-answer canary probes executed",
            fn=lambda: self.counters()["probes"],
        )
        registry.counter(
            "canary.mismatches",
            "canary probes whose answer contradicted the expectation",
            fn=lambda: self.counters()["mismatches"],
        )
        registry.counter(
            "canary.failures",
            "canary probes that errored instead of answering",
            fn=lambda: self.counters()["failures"],
        )
        registry.counter(
            "canary.slow_probes",
            "correct canary probes over the latency bound",
            fn=lambda: self.counters()["slow"],
        )
