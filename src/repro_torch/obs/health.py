"""Numerical-health rule engine: registry series → events → verdicts (the
port's copy of ``repro/obs/health.py``: the same rule names, bounds and
verdict order).

``curvature.audit`` and the downdate margins put raw numbers into the
metrics registry; this module decides what they *mean*. A
``HealthMonitor`` evaluates a small set of threshold rules against the
registry's current snapshot, appends a structured ``HealthEvent`` to a
bounded log whenever a rule starts firing (or its value materially
moves), and rolls the active set up into one per-process verdict:
``ok`` / ``degraded`` / ``critical``.

Everything a monitor produces is wire-safe (plain dicts of
ints/floats/strings), so worker verdicts ride the existing heartbeat
pongs unchanged and ``merge_health`` folds per-process reports into one
fleet view the same way ``obs.merge`` folds metric snapshots: the fleet
verdict is the *worst* member verdict, and recent events interleave by
timestamp.

Rules are data, not code — see ``default_rules()`` for the shipped set
(downdate margin, pivot clamps, condition estimate, drift residual,
non-finite fold rows, factor age). Each carries a recommendation string
so an operator (or an autotuner) reading the event knows the repair:
"schedule refresh", "raise λ", etc.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Iterable, Sequence

__all__ = [
    "HealthEvent",
    "HealthMonitor",
    "HealthRule",
    "default_rules",
    "merge_health",
]

SEVERITIES = ("ok", "degraded", "critical")
_RANK = {s: i for i, s in enumerate(SEVERITIES)}

# Relative change in a firing rule's value that warrants a fresh event
# (re-logging every evaluation would flood the bounded log with
# duplicates of one ongoing condition).
_REFIRE_FRAC = 0.5


@dataclass(frozen=True)
class HealthRule:
    """One threshold over one registry series.

    ``kind`` selects the instrument table (``gauge`` or ``counter``);
    ``op`` is ``"lt"`` (alarm when value < bound — margins) or ``"gt"``
    (alarm when value > bound — condition numbers, residuals, counts).
    Counter rules fire on the *delta* since the monitor last looked, so
    an old burst of rejects doesn't alarm forever.
    """

    name: str
    series: str
    kind: str            # "gauge" | "counter"
    op: str              # "lt" | "gt"
    bound: float
    severity: str        # "degraded" | "critical"
    recommendation: str

    def fires(self, value: float) -> bool:
        return value < self.bound if self.op == "lt" else value > self.bound


@dataclass(frozen=True)
class HealthEvent:
    """One rule transition, wire-safe via ``as_dict``."""

    ts: float
    severity: str
    rule: str
    series: str
    value: float
    bound: float
    recommendation: str

    def as_dict(self) -> dict:
        return {
            "ts": self.ts,
            "severity": self.severity,
            "rule": self.rule,
            "series": self.series,
            "value": self.value,
            "bound": self.bound,
            "recommendation": self.recommendation,
        }


def default_rules(*, margin_tol: float = 1e-3,
                  condest_bound: float = 1e8,
                  residual_bound: float = 1e-2,
                  age_bound: float = 4096.0) -> tuple[HealthRule, ...]:
    """The shipped rule set. Bounds are keyword-tunable; the defaults
    are conservative enough that a healthy serve trace stays ``ok``."""
    return (
        HealthRule(
            "downdate_margin", "curvature.downdate_margin", "gauge",
            "lt", margin_tol, "degraded",
            "downdate margin < tol: factor near loss of positive "
            "definiteness — schedule a refresh or raise damping"),
        HealthRule(
            "downdate_margin_invalid", "curvature.downdate_margin", "gauge",
            "lt", 0.0, "critical",
            "downdate margin <= 0: an invalid downdate reached the "
            "factor — refresh now and raise damping"),
        HealthRule(
            "downdate_clamped", "curvature.downdate_clamped", "counter",
            "gt", 0.0, "critical",
            "pivot clamp fired inside a downdate: the factor no longer "
            "tracks the window — refresh now"),
        HealthRule(
            "condest", "curvature.condest", "gauge",
            "gt", condest_bound, "degraded",
            "condition estimate above bound: solves are noise-amplifying "
            "— raise damping (λ)"),
        HealthRule(
            "factor_residual", "curvature.factor_residual", "gauge",
            "gt", residual_bound, "degraded",
            "Hutchinson residual above bound: the incremental factor "
            "has drifted from the window — schedule a refresh"),
        HealthRule(
            "nonfinite_folds", "serve.fold.rejected_nonfinite", "counter",
            "gt", 0.0, "degraded",
            "fold rows with NaN/Inf were rejected: check the score "
            "producer upstream"),
        HealthRule(
            "factor_age", "curvature.factor_age", "gauge",
            "gt", age_bound, "degraded",
            "factor very stale: refresh policy is not firing — check "
            "refresh_every / drift tolerances"),
    )


class HealthMonitor:
    """Evaluates rules over a registry; bounded event log; one verdict.

    ``evaluate()`` is cheap (one snapshot + a few float compares) and is
    called from the same host-sync sites that set the gauges, so health
    tracking adds no device round trips. ``record_event`` lets
    instrumentation inject events directly (e.g. the fold-row NaN guard)
    without waiting for the next rule pass.
    """

    def __init__(self, registry, *, rules: Sequence[HealthRule] | None = None,
                 max_events: int = 64,
                 clock: Callable[[], float] = time.time) -> None:
        self.registry = registry
        self.rules = tuple(rules) if rules is not None else default_rules()
        self.clock = clock
        self._lock = threading.Lock()
        self._events: deque[HealthEvent] = deque(maxlen=max_events)
        self._active: dict[str, HealthEvent] = {}
        self._counter_seen: dict[str, float] = {}

    # -- evaluation --------------------------------------------------------

    def _lookup(self, rule: HealthRule, snap: dict) -> float | None:
        if rule.kind == "counter":
            cur = snap.get("counters", {}).get(rule.series)
            if cur is None:
                return None
            prev = self._counter_seen.get(rule.series, 0.0)
            self._counter_seen[rule.series] = cur
            return cur - prev
        return snap.get("gauges", {}).get(rule.series)

    def evaluate(self) -> list[HealthEvent]:
        """One rule pass; returns the events newly logged by this pass."""
        snap = self.registry.snapshot()
        new: list[HealthEvent] = []
        with self._lock:
            for rule in self.rules:
                value = self._lookup(rule, snap)
                if value is None:           # series not reported yet
                    continue
                if not rule.fires(value):
                    self._active.pop(rule.name, None)
                    continue
                prev = self._active.get(rule.name)
                moved = prev is not None and abs(value - prev.value) > (
                    _REFIRE_FRAC * max(abs(prev.value), 1e-30))
                ev = HealthEvent(ts=self.clock(), severity=rule.severity,
                                 rule=rule.name, series=rule.series,
                                 value=float(value), bound=rule.bound,
                                 recommendation=rule.recommendation)
                self._active[rule.name] = ev
                if prev is None or moved:
                    self._events.append(ev)
                    new.append(ev)
            self._mirror_verdict_locked()
        return new

    def record_event(self, ev: HealthEvent) -> None:
        """Inject an event from instrumentation (kept active until the
        same rule name is recorded again or ``clear`` is called)."""
        with self._lock:
            self._events.append(ev)
            self._active[ev.rule] = ev
            self._mirror_verdict_locked()

    def _mirror_verdict_locked(self) -> None:
        worst = 0
        for ev in self._active.values():
            worst = max(worst, _RANK.get(ev.severity, 0))
        self.registry.gauge("health.verdict").set(float(worst))

    # -- reporting ---------------------------------------------------------

    def verdict(self) -> str:
        with self._lock:
            worst = 0
            for ev in self._active.values():
                worst = max(worst, _RANK.get(ev.severity, 0))
            return SEVERITIES[worst]

    def report(self, *, events: int = 8) -> dict:
        """Wire-safe summary: verdict + active rules + recent events."""
        with self._lock:
            worst = 0
            for ev in self._active.values():
                worst = max(worst, _RANK.get(ev.severity, 0))
            recent = list(self._events)[-events:]
            return {
                "verdict": SEVERITIES[worst],
                "active": {name: ev.as_dict()
                           for name, ev in self._active.items()},
                "events": [ev.as_dict() for ev in recent],
            }

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._active.clear()
            self._counter_seen.clear()
            self._mirror_verdict_locked()


def merge_health(reports: Iterable[dict], *, events: int = 16) -> dict:
    """Fold per-process health reports into one fleet view.

    The fleet verdict is the worst member verdict; active rules union
    (worst severity wins per rule name); events interleave by timestamp,
    newest last, bounded at ``events``.
    """
    worst = 0
    active: dict[str, dict] = {}
    all_events: list[dict] = []
    members = 0
    for rep in reports:
        if not rep:
            continue
        members += 1
        worst = max(worst, _RANK.get(rep.get("verdict", "ok"), 0))
        for name, ev in rep.get("active", {}).items():
            cur = active.get(name)
            if cur is None or (_RANK.get(ev.get("severity"), 0)
                               > _RANK.get(cur.get("severity"), 0)):
                active[name] = ev
        all_events.extend(rep.get("events", []))
    all_events.sort(key=lambda e: e.get("ts", 0.0))
    return {
        "verdict": SEVERITIES[worst],
        "members": members,
        "active": active,
        "events": all_events[-events:],
    }
