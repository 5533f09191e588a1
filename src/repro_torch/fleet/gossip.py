"""Gossiped window reconciliation — one total order of fold events
(torch port of ``repro/fleet/gossip.py``).

A replica's window is a pure function of (initial window, sequence of
fold events). So replicas never exchange factors or Grams — they exchange
the *fold columns* (the rank-k rows plus the FIFO slots they land in,
O(k·m) per event), and every replica replays every event through the
same fold path (``OnlineAdaptation.fold``). Identical initial window +
identical event order on the same kind of device ⇒ bit-identical
windows (the kernels' repeats are bit-identical), at O(n·m·k) per event
instead of an O(n²·m) Gram exchange.

Two pieces:

* ``GossipLog`` — the dispatcher-owned sequencer. It allocates the global
  FIFO slots *at admission time* (when the routed request's rows enter
  the log), so the event order is the trace order: deterministic across
  routing policies and fleet sizes. The log wraps the port's
  ``FoldJournal``, so it checkpoints and replays with the same machinery
  as a single replica's journal (and its npz loads in either package).
* ``ReplayBuffer`` — the worker-side ingester. Frames can arrive from a
  reconnect or a replay out of order; the buffer releases events only as
  an unbroken ``seq`` run, and ``OnlineAdaptation.fold(slots=...)``
  verifies each against the local FIFO cursor, so a replica can *only*
  converge to the log's window or fail loudly — never silently fork.

Refreshes are not gossiped: each replica's age/drift policy refreshes
its own factor, which bounds how far it may lag the reconciled window.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.serve.journal import FoldEvent, FoldJournal

__all__ = ["GossipLog", "ReplayBuffer"]


class GossipLog:
    """Fleet-wide sequencer of window fold events.

    ``n`` is the shared window size: the log owns the global FIFO cursor
    and stamps each event with the slots its rows replace, exactly the
    cursor arithmetic every replica's ``OnlineAdaptation`` runs locally.
    """

    def __init__(self, n: int, *, journal: Optional[FoldJournal] = None):
        if n < 1:
            raise ValueError("window size n must be >= 1")
        self.n = int(n)
        self.journal = journal if journal is not None else FoldJournal()
        # resume the cursor of a restored (possibly compacted) journal:
        # total_k counts the truncated prefix's rows via base_k
        self.slot = self.journal.total_k % self.n

    @property
    def head(self) -> int:
        """Next sequence number == events admitted over the log's life."""
        return self.journal.head

    @property
    def base(self) -> int:
        """Lowest sequence still held; history below it was compacted."""
        return self.journal.base

    @property
    def events(self) -> List[FoldEvent]:
        return self.journal.events

    def append(self, rows, *, origin: Optional[str] = None) -> FoldEvent:
        """Admit one fold: allocate its global FIFO slots and sequence it."""
        blocks = tuple(rows) if isinstance(rows, (tuple, list)) else (rows,)
        k = int(blocks[0].shape[0])
        if k > self.n:
            raise ValueError(f"cannot fold {k} rows into an n={self.n} "
                             "window")
        slots = tuple((self.slot + i) % self.n for i in range(k))
        self.slot = (self.slot + k) % self.n
        return self.journal.append_fold(slots, rows, origin=origin)

    def since(self, seq: int) -> List[FoldEvent]:
        """Events with sequence >= ``seq`` (a reconnecting worker's
        catch-up feed). Raises when ``seq`` predates the compacted
        prefix — that worker must re-seed from a fleet checkpoint."""
        return self.journal.events_since(seq)

    def compact(self, upto: int) -> int:
        """Truncate events below ``upto`` once every live replica has
        applied them and a checkpoint covers the prefix. Returns the
        number of events dropped."""
        return self.journal.compact(upto)


class ReplayBuffer:
    """Strictly ordered ingestion of gossiped events at one replica."""

    def __init__(self, start: int = 0):
        self.applied = int(start)        # next seq this replica expects
        self._pending: Dict[int, FoldEvent] = {}

    def __len__(self) -> int:
        return len(self._pending)

    def offer(self, ev: FoldEvent) -> List[FoldEvent]:
        """Buffer ``ev``; return the maximal run of consecutive events now
        ready to apply (possibly empty). Duplicates (replays of already-
        applied seqs) are dropped."""
        if ev.seq >= self.applied:
            self._pending[ev.seq] = ev
        ready = []
        while self.applied in self._pending:
            ready.append(self._pending.pop(self.applied))
            self.applied += 1
        return ready
