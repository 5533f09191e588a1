"""Flight recorder — bounded in-memory retention of the recent past,
flushed to an atomic incident bundle when health turns (torch port of
``repro/obs/recorder.py``; a bundle written by either package loads in
the other's ``obs.forensics``).

The maintained-factor design (the paper's point: fold, never
refactorize) means a numerical incident is the product of a *history* —
the verdict that flips at seq 900 was usually caused by a fold at seq
850. The health monitor detects the compounded symptom; this module
keeps the evidence: per-request digests, the fold-journal tail since the
last snapshot, cadenced ``ServeState.fingerprint()`` digests with the
margin/condest gauges at that seq, recent health events and tracer
spans — all in bounded deques, all recorded at host-sync points the
serve loop already pays for.

On a health-verdict escalation (ok → degraded/critical, or
degraded → critical) the recorder writes one **incident bundle**: the
last-good state snapshot, the journal tail that advances it to the live
head, the fingerprint series, and the merged metrics/health/trace
context — a single npz (``save_npz_bundle``: .tmp → fsync → rename, so
readers never see a torn file). A debounce window keeps a flapping
verdict from writing bundles in a loop, and ``keep`` bounds the disk
footprint (oldest bundles pruned). SIGTERM paths call
``capture("sigterm", force=True)``; ``install_exit_capture`` registers
an atexit hook that writes a final bundle only when the process dies
with a non-ok verdict (the unclean-flush case).

Offline, ``python -m repro_torch.obs.forensics <bundle>`` replays the tail
against the snapshot, verifies fingerprints seq by seq, and bisects to
the first event that crosses a health rule.
"""
from __future__ import annotations

import os
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["FlightRecorder"]

_RANK = {"ok": 0, "degraded": 1, "critical": 2}


class FlightRecorder:
    """Continuous bounded capture + debounced incident-bundle writing.

    Args:
      record_dir: directory incident bundles land in (created lazily).
      max_requests: per-request digest ring size.
      max_fingerprints: fingerprint ring size.
      fingerprint_every: take a light ``state.fingerprint(full=False)``
        (W+L only — O(n²) host bytes, never the window) every N
        ``observe`` calls (each observe rides one flush/maintenance
        boundary). The cadence is the recorder's one tunable cost knob.
      max_tail: refresh the last-good snapshot once the journal tail
        behind it exceeds this many events (bounds replay length and the
        bundle size). The snapshot only advances while the verdict is
        ``ok`` — an unhealthy state is never adopted as "last good".
      debounce_s: minimum seconds between verdict-triggered bundles.
      keep: bundles retained on disk (oldest pruned).
      max_spans: tracer spans included in a bundle.
    """

    def __init__(self, record_dir, *, max_requests: int = 512,
                 max_fingerprints: int = 256, fingerprint_every: int = 4,
                 max_tail: int = 1024, debounce_s: float = 30.0,
                 keep: int = 8, max_spans: int = 512,
                 clock=time.time):
        if fingerprint_every < 1:
            raise ValueError("fingerprint_every must be >= 1")
        self.record_dir = str(record_dir)
        self.fingerprint_every = int(fingerprint_every)
        self.max_tail = int(max_tail)
        self.debounce_s = float(debounce_s)
        self.keep = int(keep)
        self.max_spans = int(max_spans)
        self.clock = clock
        self._requests: deque = deque(maxlen=int(max_requests))
        self._fingerprints: deque = deque(maxlen=int(max_fingerprints))
        self._snap: Optional[tuple] = None     # (arrays, meta) host copy
        self._snap_seq = 0                     # journal seq of the snapshot
        self._snap_base_k = 0                  # rows folded before it
        self._obs_tick = 0
        self._last_verdict = "ok"
        self._last_capture_ts: Optional[float] = None
        self._last_capture_seq = -1
        self._last: Optional[Dict[str, Any]] = None   # refs from observe()
        self._atexit_installed = False
        self.debounced = 0                     # captures skipped by debounce
        self.bundle_paths: List[str] = []      # written by this process

    # -- continuous capture -------------------------------------------------
    def record_request(self, uid: int, *, tenant: Optional[str] = None,
                       damping: Optional[float] = None, tokens: int = 0,
                       k_rows: int = 0, latency_s: Optional[float] = None,
                       residual: Optional[float] = None) -> None:
        """One per-request digest (a dict append — request-path cheap)."""
        self._requests.append({
            "uid": int(uid), "tenant": tenant,
            "damping": None if damping is None else float(damping),
            "tokens": int(tokens), "k_rows": int(k_rows),
            "latency_s": None if latency_s is None else float(latency_s),
            "residual": None if residual is None else float(residual),
            "ts": self.clock()})

    def observe(self, state, *, adaptation=None, health=None,
                registry=None, tracer=None, origin=None) -> Optional[str]:
        """One recorder tick at a host-sync boundary (flush end /
        maintenance). Maintains the last-good snapshot, takes the
        cadenced fingerprint, and — on a verdict escalation — writes a
        debounced incident bundle. Returns the bundle path if one was
        written."""
        journal = getattr(adaptation, "journal", None) \
            if adaptation is not None else None
        self._last = {"state": state, "adaptation": adaptation,
                      "health": health, "registry": registry,
                      "tracer": tracer, "origin": origin}
        verdict = health.verdict() if health is not None else "ok"
        head = journal.head if journal is not None else 0

        # last-good snapshot maintenance: adopt the current state while
        # healthy; force re-adoption when compaction dropped the history
        # below the snapshot (replay would have no tail to stand on)
        need = self._snap is None
        if journal is not None and not need and journal.base > self._snap_seq:
            need = True
        if not need and verdict == "ok" and journal is not None \
                and head - self._snap_seq > self.max_tail:
            need = True
        if need and (verdict == "ok" or self._snap is None):
            self._take_snapshot(state, journal)

        self._obs_tick += 1
        if (self._obs_tick - 1) % self.fingerprint_every == 0:
            snap = registry.snapshot() if registry is not None else {}
            gauges = snap.get("gauges", {})
            # light digest (W+L only): every fold rewrites L, so it still
            # witnesses divergence seq-by-seq, without pulling the O(n·m)
            # window to host on the hot path. The full window digest is
            # taken once, at capture time (``live_fingerprint``).
            self._fingerprints.append({
                "seq": head, "digest": state.fingerprint(full=False),
                "full": False,
                "margin": gauges.get("curvature.downdate_margin"),
                "condest": gauges.get("curvature.condest"),
                "verdict": verdict})

        path = None
        if _RANK.get(verdict, 0) > _RANK.get(self._last_verdict, 0):
            path = self.capture(f"verdict_{verdict}")
        self._last_verdict = verdict
        return path

    def _take_snapshot(self, state, journal) -> None:
        """Host copy of the state (the whole window, O(n·m) bytes)."""
        from repro_torch.serve.state import serve_state_arrays
        self._snap = serve_state_arrays(state)
        if journal is not None:
            self._snap_seq = journal.head
            self._snap_base_k = journal.total_k
        else:
            self._snap_seq = 0
            self._snap_base_k = 0

    # -- incident bundles ---------------------------------------------------
    def capture(self, reason: str, *, force: bool = False) -> Optional[str]:
        """Write one incident bundle from the last-observed refs. Debounced
        unless ``force``; returns the path (None when skipped or when
        nothing was ever observed)."""
        if self._last is None:
            return None
        now = self.clock()
        if not force and self._last_capture_ts is not None \
                and now - self._last_capture_ts < self.debounce_s:
            self.debounced += 1
            return None

        from repro_torch.checkpoint.fleet import save_npz_bundle
        from repro_torch.serve.journal import event_rows_blocks, host_block

        state = self._last["state"]
        adaptation = self._last["adaptation"]
        health = self._last["health"]
        registry = self._last["registry"]
        tracer = self._last["tracer"]
        journal = getattr(adaptation, "journal", None) \
            if adaptation is not None else None
        if self._snap is None:
            self._take_snapshot(state, journal)
        snap_arrays, snap_meta = self._snap

        arrays = {f"snap_{k}": v for k, v in snap_arrays.items()}
        tail = journal.events_since(self._snap_seq) \
            if journal is not None else []
        evs = []
        for ev in tail:
            blocks = event_rows_blocks(ev.rows)
            safe = []
            for b, arr in enumerate(blocks):
                a, dt = host_block(arr)
                safe.append(dt)
                arrays[f"ev{ev.seq}_b{b}"] = a
            evs.append({"seq": ev.seq, "kind": ev.kind,
                        "slots": list(ev.slots), "origin": ev.origin,
                        "n_blocks": len(blocks), "dtypes": safe})
        head = journal.head if journal is not None else self._snap_seq

        meta = {
            "kind": "incident_bundle", "version": 1,
            "reason": str(reason), "ts": now,
            "origin": self._last.get("origin"),
            "verdict": health.verdict() if health is not None else "ok",
            "snap_seq": self._snap_seq, "head_seq": head,
            "base_k": self._snap_base_k,
            "live_fingerprint": state.fingerprint(),
            "jitter": float(getattr(adaptation, "jitter", 0.0) or 0.0),
            "fifo_n": getattr(adaptation, "fifo_n", None)
            if adaptation is not None else None,
            "audit_every": int(getattr(adaptation, "audit_every", 0) or 0)
            if adaptation is not None else 0,
            "state": snap_meta,
            "journal": {"base": self._snap_seq, "events": evs},
            "fingerprints": list(self._fingerprints),
            "requests": list(self._requests),
            "health": health.report(events=32)
            if health is not None else None,
            "metrics": registry.snapshot() if registry is not None else None,
            "spans": tracer.events()[-self.max_spans:]
            if tracer is not None else [],
            "debounced": self.debounced,
        }
        name = f"incident_{head:09d}_{_slug(reason)}.npz"
        path = save_npz_bundle(os.path.join(self.record_dir, name),
                               arrays, meta)
        self._last_capture_ts = now
        self._last_capture_seq = head
        self.bundle_paths.append(str(path))
        self._prune()
        return str(path)

    def _prune(self) -> None:
        while len(self.bundle_paths) > self.keep:
            old = self.bundle_paths.pop(0)
            try:
                os.remove(old)
            except OSError:
                pass

    # -- unclean-exit capture ----------------------------------------------
    def install_exit_capture(self) -> None:
        """atexit hook: write a final bundle if the process exits while
        the last-seen verdict is non-ok (the flush never came back
        clean). SIGTERM paths should call ``capture("sigterm",
        force=True)`` directly — signal handlers know they are dying;
        atexit only knows how healthy the process last looked."""
        if self._atexit_installed:
            return
        self._atexit_installed = True
        import atexit
        atexit.register(self._exit_capture)

    def _exit_capture(self) -> None:
        try:
            if self._last_verdict != "ok":
                self.capture("exit_unclean", force=True)
        except BaseException:
            pass                     # never let atexit raise


def _slug(reason: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "_"
                   for c in str(reason))[:40]
