"""Resilience envelope: the typed failures and request deadlines.

Counterpart of ``sbeacon_tpu/resilience.py:37-165``: the error taxonomy
(``ResilienceError`` and its ``DeadlineExceeded`` 504, ``BatchTimeout``
503, ``Overloaded`` 429 and ``CircuitOpen`` 503), ``Deadline``,
``NO_DEADLINE``, ``current_deadline`` and ``deadline_scope``. A request
deadline enters at the caller and propagates ambiently (thread-local)
into every blocking wait of the micro-batcher, which raises
``DeadlineExceeded`` when the request's own deadline lapsed and
``BatchTimeout`` when only the batch timeout did. The admission
controller and the circuit breaker of the JAX module are not ported
yet.

Stdlib only and importable from any layer.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager


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
