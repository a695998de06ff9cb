"""Deterministic fault injection for chaos tests.

Counterpart of ``sbeacon_tpu/harness/faults.py``, copied whole (it is
stdlib only): ``FaultRule``, ``FaultPlan``, ``FaultInjector``,
``install`` / ``uninstall`` / ``installed``, ``install_from_env``
(``BEACON_FAULT_PLAN``, JSON or ``@path``), ``fault_point`` and
``FaultError``. Sites in the serving path call :func:`fault_point` (a
no-op until a plan is installed); a :class:`FaultPlan` names sites,
fault kinds, and seeded activation rules, and :func:`install` arms it
process-wide. Decisions are made by a per-rule ``random.Random`` seeded
from ``(plan.seed, site, rule index)`` over a per-rule hit counter, so
for a given call sequence the same plan activates the same faults every
run.

The port calls one site: ``kernel.launch`` — device kernel dispatch
(``serving.py`` micro-batch execute, and the engine's direct launches
when the micro-batcher is off). The JAX package's other sites
(``worker.http``, ``sqlite.commit``, ``admission.queue``,
``mesh.dispatch``, ``compaction.fold``, ``migration:*``) belong to
modules this package has not ported.

Fault kinds: ``error`` raises :class:`FaultError`; ``latency`` sleeps
``ms``; ``hang`` sleeps ``ms`` too but defaults much longer — a hang is
only distinguishable from latency by exceeding every caller's deadline.

Install via code (tests), or ``BEACON_FAULT_PLAN`` for chaos runs::

    BEACON_FAULT_PLAN='{"seed": 7, "rules": [
        {"site": "kernel.launch", "kind": "error", "rate": 0.05}]}'
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import threading
import time


class FaultError(RuntimeError):
    """An injected failure (never raised by real code paths)."""


@dataclasses.dataclass(frozen=True)
class FaultRule:
    site: str
    kind: str = "error"  # error | latency | hang
    rate: float = 1.0  # activation probability per eligible hit
    ms: float = 0.0  # latency duration; hang defaults to 60 s
    after: int = 0  # skip the first N hits of this rule's site
    count: int | None = None  # max activations (None = unlimited)
    match: str = ""  # substring filter on the site's detail

    def __post_init__(self):
        if self.kind not in ("error", "latency", "hang"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if not (0.0 <= self.rate <= 1.0):
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    rules: tuple[FaultRule, ...] = ()
    seed: int = 0

    @classmethod
    def from_dict(cls, doc: dict) -> "FaultPlan":
        return cls(
            rules=tuple(FaultRule(**r) for r in doc.get("rules", [])),
            seed=int(doc.get("seed", 0)),
        )

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls.from_dict(json.loads(text))

    def dumps(self) -> str:
        return json.dumps(
            {
                "seed": self.seed,
                "rules": [dataclasses.asdict(r) for r in self.rules],
            }
        )


class FaultInjector:
    """Armed plan: per-rule seeded RNG + hit/activation counters."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._rng = [
            random.Random(f"{plan.seed}:{r.site}:{i}")
            for i, r in enumerate(plan.rules)
        ]
        self._hits = [0] * len(plan.rules)
        self._activations = [0] * len(plan.rules)

    def hit(self, site: str, detail: str = "") -> None:
        """Evaluate every rule for ``site``; apply the first that
        activates (one fault per point keeps plans composable)."""
        action: tuple[str, float, str] | None = None
        with self._lock:
            for i, r in enumerate(self.plan.rules):
                if r.site != site:
                    continue
                if r.match and r.match not in detail:
                    continue
                n = self._hits[i]
                self._hits[i] += 1
                if n < r.after:
                    continue
                if r.count is not None and self._activations[i] >= r.count:
                    continue
                # the draw happens for every eligible hit, activated or
                # not, so the decision sequence is a pure function of
                # (seed, site, rule index, hit number)
                draw = self._rng[i].random()
                if draw >= r.rate:
                    continue
                self._activations[i] += 1
                ms = r.ms if r.ms > 0 else (60_000.0 if r.kind == "hang" else 0.0)
                action = (r.kind, ms, f"injected {site} failure (hit {n})")
                break
        if action is None:
            return
        kind, ms, msg = action
        if kind == "error":
            raise FaultError(msg)
        # latency / hang: sleep OUTSIDE the lock so a hung site never
        # blocks other sites' decisions
        time.sleep(ms / 1e3)

    def stats(self) -> dict:
        """Per-rule hit/activation counts (chaos-run observability)."""
        with self._lock:
            return {
                f"{r.site}[{i}]{':' + r.match if r.match else ''}": {
                    "kind": r.kind,
                    "hits": self._hits[i],
                    "activations": self._activations[i],
                }
                for i, r in enumerate(self.plan.rules)
            }


_installed: FaultInjector | None = None


def install(plan: FaultPlan | dict) -> FaultInjector:
    """Arm a plan process-wide; returns the injector (for .stats())."""
    global _installed
    if isinstance(plan, dict):
        plan = FaultPlan.from_dict(plan)
    _installed = FaultInjector(plan)
    return _installed


def uninstall() -> None:
    global _installed
    _installed = None


def installed() -> FaultInjector | None:
    return _installed


def install_from_env(env=None) -> FaultInjector | None:
    """Arm BEACON_FAULT_PLAN if set (JSON, or @path to a JSON file),
    so a chaos scenario runs against a process without code changes.
    The package has no server entry yet; a script that drives the
    engine calls this itself."""
    env = os.environ if env is None else env
    raw = env.get("BEACON_FAULT_PLAN", "").strip()
    if not raw:
        return None
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            raw = f.read()
    return install(FaultPlan.from_json(raw))


def fault_point(site: str, detail: str = "") -> None:
    """Instrumentation hook: no-op unless a plan is installed."""
    inj = _installed
    if inj is not None:
        inj.hit(site, detail)
