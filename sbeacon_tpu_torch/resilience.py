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
HTTP layer and the query runner's pool. The circuit breaker of the JAX
module belongs to the fleet plane and is not ported yet.

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
