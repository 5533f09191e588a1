"""Fold journal — the window's maintenance history as replayable events
(torch port of ``repro/serve/journal.py``).

Every mutation of the resident window is one of two things: a FIFO fold
(k rows enter at explicit slots, k leave) or a full refresh (a
refactorization of the current S). Both are deterministic functions of
the state they act on, so a log of them is the window: a fresh
``ServeState`` seeded from the same initial window and driven through the
same events on the same device lands on the bit-identical S, W and L (the
kernels' repeats are bit-identical).

``OnlineAdaptation`` appends each applied fold — its rows, as stored in
the window, plus the slots they landed in — and each refresh. Slots ride
in the event so a replayer can verify the order: ``fold(..., slots=...)``
raises on any divergence from the local FIFO cursor.

``compact(upto)`` drops the prefix a checkpoint covers. Sequence numbers
are absolute: ``base`` counts the events compacted away and ``base_k``
the rows they folded, so a FIFO cursor resumes as ``total_k % n``;
``events_since`` below ``base`` raises.

The npz form is the reference's: one ``ev<seq>_b<block>`` array a row
block and a JSON manifest under ``__meta__`` (``base``, ``base_k``,
``events``). A bf16 block is written as numpy writes an ``ml_dtypes``
bfloat16 array, raw two-byte records (``|V2``), and read back as bf16.
"""
from __future__ import annotations

import json
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["FoldEvent", "FoldJournal", "event_rows_blocks", "host_block"]


class FoldEvent(NamedTuple):
    """One window maintenance event.

    ``kind``: "fold" (rows enter the FIFO at ``slots``) or "refresh"
    (``slots``/``rows`` empty). ``seq``: position in the journal's total
    order. ``origin``: opaque id of the replica that first applied it.
    """
    seq: int
    kind: str
    slots: Tuple[int, ...]
    rows: Any                    # (k, m) tensor/array, per-block tuple,
    origin: Optional[str] = None  # or None for refresh events

    @property
    def k(self) -> int:
        return len(self.slots)


def event_rows_blocks(rows) -> tuple:
    """An event's rows as a tuple of (k, m_b) blocks (tensors or arrays,
    as stored)."""
    if rows is None:
        return ()
    if isinstance(rows, (tuple, list)):
        return tuple(rows)
    return (rows,)


def host_block(block) -> Tuple[np.ndarray, str]:
    """(a host numpy copy, its dtype name) of one row block; bf16 — a
    tensor, an ``ml_dtypes`` array or raw ``|V2`` records — comes back as
    its uint16 bits, named "bfloat16"."""
    if isinstance(block, torch.Tensor):
        t = block.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.asarray(block)
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def _rows_tensor(a: np.ndarray) -> torch.Tensor:
    """A stored row block as a CPU tensor (``|V2`` records are bf16)."""
    if a.dtype == np.dtype("V2"):
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


class FoldJournal:
    """Serializable log of window maintenance events: append at ``head``,
    truncate the checkpoint-covered prefix with ``compact``."""

    def __init__(self, events: Optional[List[FoldEvent]] = None, *,
                 base: int = 0, base_k: int = 0):
        self.events: List[FoldEvent] = list(events or [])
        self.base = int(base)          # seq of events[0]; compacted below
        self.base_k = int(base_k)      # rows folded by compacted events
        if self.events and self.events[0].seq != self.base:
            raise ValueError(f"first event seq {self.events[0].seq} != "
                             f"journal base {self.base}")

    def __len__(self) -> int:
        return len(self.events)

    @property
    def head(self) -> int:
        """The next sequence number (compacted prefix included)."""
        return self.base + len(self.events)

    @property
    def total_k(self) -> int:
        """Rows folded over the journal's whole history, compacted prefix
        included."""
        return self.base_k + sum(ev.k for ev in self.events)

    def append_fold(self, slots, rows, *, origin: Optional[str] = None
                    ) -> FoldEvent:
        ev = FoldEvent(seq=self.head, kind="fold",
                       slots=tuple(int(s) for s in slots), rows=rows,
                       origin=origin)
        self.events.append(ev)
        return ev

    def append_refresh(self, *, origin: Optional[str] = None) -> FoldEvent:
        ev = FoldEvent(seq=self.head, kind="refresh", slots=(), rows=None,
                       origin=origin)
        self.events.append(ev)
        return ev

    def append_event(self, ev: FoldEvent) -> FoldEvent:
        """Append an externally sequenced event; its ``seq`` must continue
        this journal's order."""
        if ev.seq != self.head:
            raise ValueError(f"event seq {ev.seq} does not continue the "
                             f"journal (head {self.head})")
        self.events.append(ev)
        return ev

    def compact(self, upto: int) -> int:
        """Drop events with seq < ``upto`` (covered by a checkpoint).
        ``upto`` beyond ``head`` clamps; below ``base`` is a no-op.
        Returns the number of events dropped."""
        upto = min(int(upto), self.head)
        drop = upto - self.base
        if drop <= 0:
            return 0
        dropped, self.events = self.events[:drop], self.events[drop:]
        self.base = upto
        self.base_k += sum(ev.k for ev in dropped)
        return len(dropped)

    def events_since(self, seq: int) -> List[FoldEvent]:
        """Events with sequence >= ``seq``. Raises if that history was
        compacted away: restore from a checkpoint at or after ``base`` and
        replay the tail instead."""
        seq = int(seq)
        if seq < self.base:
            raise ValueError(f"events below seq {self.base} were compacted "
                             f"(asked for {seq}); restore from a checkpoint "
                             "and replay the tail")
        return self.events[seq - self.base:]

    # -- serialization (npz arrays + json meta, the reference's form) -------
    def save(self, path) -> None:
        """One .npz: a ``ev<seq>_b<block>`` array a row block and the JSON
        manifest. A compacted journal saves only its tail."""
        evs, arrays = [], {}
        for ev in self.events:
            blocks = event_rows_blocks(ev.rows)
            evs.append({"seq": ev.seq, "kind": ev.kind,
                        "slots": list(ev.slots), "origin": ev.origin,
                        "n_blocks": len(blocks)})
            for b, block in enumerate(blocks):
                a, dtype = host_block(block)
                arrays[f"ev{ev.seq}_b{b}"] = \
                    a.view("V2") if dtype == "bfloat16" else a
        meta = {"base": self.base, "base_k": self.base_k, "events": evs}
        arrays["__meta__"] = np.frombuffer(
            json.dumps(meta).encode("utf-8"), np.uint8)
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path) -> "FoldJournal":
        """Read a journal npz of either package; rows come back as CPU
        tensors."""
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
            if isinstance(meta, list):          # pre-compaction manifests
                meta = {"base": 0, "base_k": 0, "events": meta}
            events = []
            for e in meta["events"]:
                blocks = tuple(_rows_tensor(z[f"ev{e['seq']}_b{b}"])
                               for b in range(e["n_blocks"]))
                rows = None if not blocks else \
                    (blocks[0] if e["n_blocks"] == 1 else blocks)
                events.append(FoldEvent(seq=e["seq"], kind=e["kind"],
                                        slots=tuple(e["slots"]), rows=rows,
                                        origin=e.get("origin")))
        return cls(events, base=meta["base"], base_k=meta["base_k"])

    # -- replay ---------------------------------------------------------------
    def replay(self, state, adaptation, *, record: bool = False):
        """Drive a ``ServeState`` through the journal. From the same initial
        state on the same device this reproduces the origin's S, W and L
        bit for bit. ``record=False`` keeps the adaptation's own journal
        out of the loop."""
        for ev in self.events:
            if ev.kind == "fold":
                state = adaptation.fold(state, ev.rows, slots=ev.slots,
                                        record=record)
            elif ev.kind == "refresh":
                state, _ = adaptation.maybe_refresh(state, force=True,
                                                    record=record)
            else:
                raise ValueError(f"unknown event kind {ev.kind!r}")
        return state
