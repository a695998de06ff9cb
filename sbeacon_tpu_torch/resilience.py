"""Resilience envelope: the typed failures and request deadlines.

Counterpart of ``sbeacon_tpu/resilience.py:37-165``: the error taxonomy
(``ResilienceError`` and its ``DeadlineExceeded`` 504, ``BatchTimeout``
503, ``Overloaded`` 429 and ``CircuitOpen`` 503), ``Deadline``,
``NO_DEADLINE``, ``current_deadline`` and ``deadline_scope``. A request
deadline enters at the caller and propagates ambiently (thread-local)
into every blocking wait of the micro-batcher, which raises
``DeadlineExceeded`` when the request's own deadline lapsed and
``BatchTimeout`` when only the batch timeout did. The admission gate
(``AdmissionController``, ``register_admission_metrics``,
``resilience.py:166-285`` there) bounds the requests in flight at the
HTTP layer and the query runner's pool. The per-key circuit breaker
(``_Circuit``, ``CircuitBreaker`` with its ``CLOSED``/``OPEN``/
``HALF_OPEN`` states, and ``register_breaker_metrics``, ``:288-466``)
gates a fleet coordinator's worker routes.

Stdlib only and importable from any layer.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from .telemetry import publish_event


# -- typed failures -----------------------------------------------------------


class ResilienceError(RuntimeError):
    """Base for envelope failures; carries the HTTP status the API layer
    maps it to and an optional client backoff hint."""

    status: int = 503
    retry_after_s: float | None = None


class DeadlineExceeded(ResilienceError):
    """The request's deadline expired before the work completed."""

    status = 504


class BatchTimeout(ResilienceError):
    """A micro-batch submit saw no kernel launch within its timeout —
    the wedged-leader failure that used to hang followers forever."""

    status = 503


class Overloaded(ResilienceError):
    """Admission refused: the server is at its in-flight cap (or a
    bounded worker pool is full). Fast-fail so clients back off instead
    of queueing into a timeout."""

    status = 429

    def __init__(self, message: str, *, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class CircuitOpen(ResilienceError):
    """A route's circuit breaker is open: the target failed repeatedly
    and calls fast-fail until the reset timeout elapses."""

    status = 503


# -- request deadlines --------------------------------------------------------


class Deadline:
    """An absolute expiry on the monotonic clock; ``NO_DEADLINE`` (the
    ``expires_at is None`` instance) never expires.

    Deadlines are combined with ``min`` semantics: a tighter local
    timeout never extends the request's deadline, and vice versa.
    """

    __slots__ = ("expires_at",)

    def __init__(self, expires_at: float | None):
        self.expires_at = expires_at

    @classmethod
    def after(cls, seconds: float | None) -> "Deadline":
        """Deadline ``seconds`` from now; None/<=0 means no deadline."""
        if seconds is None or seconds <= 0:
            return NO_DEADLINE
        return cls(time.monotonic() + seconds)

    def remaining(self) -> float | None:
        """Seconds left (>= 0.0), or None when unbounded."""
        if self.expires_at is None:
            return None
        return max(0.0, self.expires_at - time.monotonic())

    def expired(self) -> bool:
        return (
            self.expires_at is not None
            and time.monotonic() >= self.expires_at
        )

    def clamp(self, timeout_s: float | None) -> float | None:
        """The tighter of this deadline's remaining time and a local
        timeout; None only when both are unbounded."""
        rem = self.remaining()
        if rem is None:
            return timeout_s
        if timeout_s is None:
            return rem
        return min(rem, timeout_s)

    def combine(self, timeout_s: float | None) -> "Deadline":
        """This deadline tightened by a local timeout-from-now."""
        if timeout_s is None:
            return self
        other = time.monotonic() + timeout_s
        if self.expires_at is None or other < self.expires_at:
            return Deadline(other)
        return self

    def check(self, what: str = "request") -> None:
        if self.expired():
            raise DeadlineExceeded(f"{what}: deadline exceeded")

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        r = self.remaining()
        return f"Deadline({'inf' if r is None else f'{r:.3f}s'})"


NO_DEADLINE = Deadline(None)

_ambient = threading.local()


def current_deadline() -> Deadline:
    """The deadline the HTTP layer scoped onto this thread (or
    NO_DEADLINE). Blocking waits clamp themselves by it without every
    call signature having to thread a deadline argument through."""
    return getattr(_ambient, "deadline", NO_DEADLINE)


@contextmanager
def deadline_scope(deadline: Deadline):
    """Install ``deadline`` as this thread's ambient deadline."""
    prev = getattr(_ambient, "deadline", NO_DEADLINE)
    _ambient.deadline = deadline
    try:
        yield deadline
    finally:
        _ambient.deadline = prev


# -- admission control --------------------------------------------------------


class AdmissionController:
    """Bounded in-flight gate: at most ``max_in_flight`` admitted
    requests at once, the rest fast-fail with 429 + Retry-After, so
    saturation answers in microseconds instead of queueing every excess
    request into the HTTP server's accept backlog."""

    #: minimum seconds between admission-shed flight-recorder events —
    #: a 429 flood is ONE incident, not thousands of journal entries
    SHED_EVENT_INTERVAL_S = 1.0

    def __init__(
        self, max_in_flight: int = 64, *, retry_after_s: float = 1.0
    ):
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        self.max_in_flight = max_in_flight
        self.retry_after_s = retry_after_s
        self._lock = threading.Lock()
        self._in_flight = 0
        self._admitted = 0
        self._shed = 0
        self._last_shed_event = 0.0

    def try_acquire(self) -> bool:
        """Take one slot if available (False = shed, counted); callers
        that release from another thread (e.g. a worker pool) pair this
        with :meth:`release` instead of the ``admit`` scope."""
        with self._lock:
            if self._in_flight >= self.max_in_flight:
                self._shed += 1
                now = time.monotonic()
                fire = (
                    now - self._last_shed_event
                    >= self.SHED_EVENT_INTERVAL_S
                )
                if fire:
                    self._last_shed_event = now
                shed, in_flight = self._shed, self._in_flight
            else:
                self._in_flight += 1
                self._admitted += 1
                return True
        if fire:  # journal write outside the hot-path lock
            publish_event(
                "admission.shed",
                shed=shed,
                in_flight=in_flight,
                max_in_flight=self.max_in_flight,
            )
        return False

    def release(self) -> None:
        with self._lock:
            self._in_flight -= 1

    @contextmanager
    def admit(self):
        if not self.try_acquire():
            raise Overloaded(
                f"server at capacity ({self.max_in_flight} in flight)",
                retry_after_s=self.retry_after_s,
            )
        try:
            yield
        finally:
            self.release()

    def metrics(self) -> dict:
        with self._lock:
            return {
                "max_in_flight": self.max_in_flight,
                "in_flight": self._in_flight,
                "admitted": self._admitted,
                "shed": self._shed,
            }


def register_admission_metrics(registry, supplier) -> None:
    """Register the server admission gate's typed instruments.

    ``supplier`` is a zero-arg callable returning the CURRENT
    AdmissionController — the app may swap its controller at runtime
    (tests do), so instruments must read through the owner, not bind
    one instance."""

    def field(name):
        return lambda: supplier().metrics()[name]

    registry.gauge(
        "admission.max_in_flight",
        "configured in-flight request cap",
        fn=field("max_in_flight"),
    )
    registry.gauge(
        "admission.in_flight",
        "requests currently admitted",
        fn=field("in_flight"),
    )
    registry.counter(
        "admission.admitted",
        "requests admitted since start",
        fn=field("admitted"),
    )
    registry.counter(
        "admission.shed",
        "requests shed with 429 at the admission gate",
        fn=field("shed"),
    )


# -- circuit breaker ----------------------------------------------------------

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class _Circuit:
    __slots__ = ("state", "failures", "opened_at", "probes_left", "opens")

    def __init__(self):
        self.state = CLOSED
        self.failures = 0
        self.opened_at = 0.0
        self.probes_left = 0
        self.opens = 0  # lifetime open transitions (observability)


class CircuitBreaker:
    """Per-key consecutive-failure breaker with half-open probing.

    closed --[``failure_threshold`` consecutive failures]--> open
    open --[``reset_timeout_s`` elapsed]--> half-open
    half-open: up to ``half_open_probes`` calls pass; one success closes,
    one failure re-opens (fresh reset window).

    ``allow(key)`` is the call-site gate — it consumes a probe slot in
    half-open, so call it once per attempted call. Thread-safe; the
    clock is injectable so tests drive transitions without sleeping.
    """

    def __init__(
        self,
        *,
        failure_threshold: int = 5,
        reset_timeout_s: float = 30.0,
        half_open_probes: int = 1,
        clock=time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.half_open_probes = max(1, half_open_probes)
        self._clock = clock
        self._lock = threading.Lock()
        self._circuits: dict[str, _Circuit] = {}

    def _get(self, key: str) -> _Circuit:
        c = self._circuits.get(key)
        if c is None:
            c = self._circuits[key] = _Circuit()
        return c

    def allow(self, key: str) -> bool:
        half_opened = False
        try:
            with self._lock:
                c = self._get(key)
                if c.state == CLOSED:
                    return True
                now = self._clock()
                if c.state == OPEN:
                    if now - c.opened_at < self.reset_timeout_s:
                        return False
                    c.state = HALF_OPEN
                    c.opened_at = now  # stamp half-open entry for the
                    c.probes_left = self.half_open_probes  # escape below
                    half_opened = True
                if c.probes_left > 0:
                    c.probes_left -= 1
                    return True
                # every probe was consumed but no outcome was ever
                # recorded (probe holder died before the call, deadline
                # expired between allow() and the attempt,
                # non-conclusive response): HALF_OPEN must not be a
                # terminal state — replenish after another reset
                # window, like a fresh open->half-open lapse
                if now - c.opened_at >= self.reset_timeout_s:
                    c.opened_at = now
                    c.probes_left = self.half_open_probes - 1
                    return True
                return False
        finally:
            if half_opened:
                publish_event("breaker.half_open", route=key)

    def record_success(self, key: str) -> None:
        with self._lock:
            c = self._get(key)
            closed = c.state != CLOSED
            c.state = CLOSED
            c.failures = 0
        if closed:
            publish_event("breaker.close", route=key)

    def record_failure(self, key: str) -> None:
        opened = False
        with self._lock:
            c = self._get(key)
            c.failures += 1
            reopen = c.state == HALF_OPEN
            if reopen or c.failures >= self.failure_threshold:
                if c.state != OPEN:
                    c.opens += 1
                    opened = True
                c.state = OPEN
                c.opened_at = self._clock()
            failures = c.failures
        if opened:
            publish_event(
                "breaker.open", route=key, consecutive_failures=failures
            )

    def state(self, key: str) -> str:
        with self._lock:
            c = self._circuits.get(key)
            if c is None:
                return CLOSED
            # surface the lapsed-open -> half-open transition without
            # consuming a probe (pure observation)
            if (
                c.state == OPEN
                and self._clock() - c.opened_at >= self.reset_timeout_s
            ):
                return HALF_OPEN
            return c.state

    def metrics(self) -> dict:
        with self._lock:
            return {
                key: {
                    "state": c.state,
                    "consecutive_failures": c.failures,
                    "opens": c.opens,
                }
                for key, c in sorted(self._circuits.items())
            }


#: numeric encoding of circuit states for gauge series (Prometheus
#: cannot carry strings as values): closed=0, open=1, half_open=2
BREAKER_STATE_CODE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


def register_breaker_metrics(registry, supplier) -> None:
    """Per-route circuit series. ``supplier`` returns the CircuitBreaker
    (or None when the engine has no worker routes — the series then
    render empty but the names stay registered, so dashboards never see
    them flap in and out of existence). ``json_render=False`` keeps the
    historical ``/metrics`` JSON shape — ``{route: {state, ...}}``,
    overlaid by the app — while Prometheus gets typed labeled series."""

    def per_route(field, code=None):
        def collect():
            b = supplier()
            if b is None:
                return {}
            return {
                route: (code[v[field]] if code else v[field])
                for route, v in b.metrics().items()
            }

        return collect

    registry.gauge(
        "breaker.state",
        "circuit state per worker route (0=closed 1=open 2=half_open)",
        label="route",
        json_render=False,
        fn=per_route("state", BREAKER_STATE_CODE),
    )
    registry.gauge(
        "breaker.consecutive_failures",
        "consecutive failures per worker route",
        label="route",
        json_render=False,
        fn=per_route("consecutive_failures"),
    )
    registry.counter(
        "breaker.opens",
        "lifetime open transitions per worker route",
        label="route",
        json_render=False,
        fn=per_route("opens"),
    )
