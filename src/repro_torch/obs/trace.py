"""Per-request span tracing with Chrome-trace/Perfetto export (the port's
copy of ``repro/obs/trace.py``; the two packages' traces stitch together).

A request's life is submit → queue → coalesce → dispatch → device
solve → fold → respond, and under the fleet those stages happen in
*different processes*.  The tracer records complete spans ("X" phase
events in Chrome trace format) stamped with a shared ``trace`` id; the
dispatcher puts the id on the solve frame, the worker tags its spans
with the same id and ships them back on the result frame, and
``export`` writes one JSON all the spans stitch together in.

Timestamps are epoch microseconds (``time.time``-based) so spans from
different processes land on one timeline; durations are measured with
``perf_counter`` for resolution.  The event buffer is a bounded deque
— a long-lived server keeps the most recent window, never grows
without limit.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Iterable

__all__ = ["Tracer", "Span"]


class Span:
    """Handle for an open span; finished via the Tracer context manager."""

    __slots__ = ("name", "cat", "trace", "args", "ts_us", "_t0")

    def __init__(self, name: str, cat: str, trace: str | None, args: dict | None):
        self.name = name
        self.cat = cat
        self.trace = trace
        self.args = args
        self.ts_us = time.time() * 1e6
        self._t0 = time.perf_counter()


class Tracer:
    """Bounded in-process span recorder, wire-shippable and exportable."""

    def __init__(self, max_events: int = 65536, pid: int | None = None) -> None:
        self._lock = threading.Lock()
        self._events: deque[dict] = deque(maxlen=max_events)
        self._pending: deque[dict] = deque(maxlen=max_events)
        self.pid = os.getpid() if pid is None else pid

    def add(
        self,
        name: str,
        *,
        cat: str = "serve",
        ts_us: float,
        dur_us: float,
        trace: str | None = None,
        args: dict | None = None,
        pid: int | None = None,
        tid: int | None = None,
    ) -> None:
        """Record one complete span (used for spans timed externally)."""
        ev = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": ts_us,
            "dur": dur_us,
            "pid": self.pid if pid is None else pid,
            "tid": threading.get_ident() % 2**31 if tid is None else tid,
        }
        a = dict(args) if args else {}
        if trace is not None:
            a["trace"] = trace
        if a:
            ev["args"] = a
        with self._lock:
            self._events.append(ev)
            self._pending.append(ev)

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        *,
        cat: str = "serve",
        trace: str | None = None,
        args: dict | None = None,
    ):
        s = Span(name, cat, trace, args)
        try:
            yield s
        finally:
            dur_us = (time.perf_counter() - s._t0) * 1e6
            self.add(
                s.name,
                cat=s.cat,
                ts_us=s.ts_us,
                dur_us=dur_us,
                trace=s.trace,
                args=s.args,
            )

    def ingest(self, events: Iterable[dict]) -> None:
        """Adopt spans recorded by another process (they keep their pid)."""
        with self._lock:
            for ev in events:
                self._events.append(dict(ev))

    def drain(self) -> list[dict]:
        """Return-and-clear spans not yet shipped (worker → wire)."""
        with self._lock:
            out = list(self._pending)
            self._pending.clear()
        return out

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def export(self, path: str) -> int:
        """Write Chrome trace JSON; returns the number of events written.

        Load the file in ``chrome://tracing`` or https://ui.perfetto.dev.
        """
        evs = self.events()
        doc = {"traceEvents": evs, "displayTimeUnit": "ms"}
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return len(evs)
