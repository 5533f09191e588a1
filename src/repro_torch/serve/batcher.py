"""Token-budget request batcher — coalescing serve traffic for the solver
(torch port of ``repro/serve/batcher.py``).

Requests each carry one right-hand side (a flat (m,) vector or per-block
pieces), a per-request λ and a token cost. The batcher coalesces them
FIFO into microbatches whose stacked RHS is the multi-RHS shape the dual
solve consumes — ``V`` (m, k), or per-block (m_b, k) pieces for a blocked
window — so one pass over S serves the whole microbatch.

A microbatch closes before the next request would exceed ``max_tokens``
or ``max_requests``. A request bigger than the whole budget is split off
alone once it reaches the queue head (``oversize="split"``) or refused at
``submit`` (``oversize="reject"``). ``bucket=True`` pads the stacked RHS
with zero columns up to power-of-two widths (λ padding 1.0). The head
request fixes the microbatch's tenant; admission skips other tenants'
requests, keeping FIFO order per tenant.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Iterator, List, NamedTuple, Optional, Tuple

import torch

__all__ = ["SolveRequest", "Microbatch", "TokenBudgetBatcher"]


@dataclasses.dataclass
class SolveRequest:
    """One request awaiting a damped-Fisher solve. ``rows``: optional
    per-sample score rows ((k_ex, m) or per-block pieces) that the online
    adaptation folds into the window after the solve."""
    uid: int
    v: Any
    damping: float
    tokens: int = 1
    rows: Any = None
    payload: Any = None
    t_submit: float = 0.0       # stamped by the server for latency stats
    tenant: Optional[str] = None
    trace: Optional[str] = None   # obs trace id of the request's spans
    # the async server's place of the submit among its calls, and the
    # damping state pinned at that call (``dist.AsyncSolveServer``)
    seq: int = -1
    dstate: Any = None


class Microbatch(NamedTuple):
    """A coalesced solver batch: ``V`` holds one RHS column per request
    (plus zero pad columns), ``dampings`` the per-column λ (pad columns
    1.0, a float32 CPU tensor). ``requests[j]`` owns column j."""
    requests: Tuple[SolveRequest, ...]
    V: Any                      # (m, k_pad) or tuple of (m_b, k_pad)
    dampings: torch.Tensor      # (k_pad,) float32
    tokens: int
    tenant: Optional[str] = None

    @property
    def k(self) -> int:
        return len(self.requests)


def _bucket_width(k: int, cap: int) -> int:
    """Smallest power of two ≥ k, clamped to cap."""
    w = 1
    while w < k:
        w *= 2
    return min(w, max(cap, k))


def _stack_columns(vs: List[Any], pad_to: int):
    """Stack per-request RHS (flat or blocked) into solver columns."""
    def stack(cols):
        V = torch.stack([torch.as_tensor(c).reshape(-1) for c in cols], dim=1)
        if pad_to > V.shape[1]:
            V = torch.cat([V, V.new_zeros((V.shape[0], pad_to - V.shape[1]))],
                          dim=1)
        return V

    if isinstance(vs[0], (tuple, list)):
        widths = tuple(len(v) for v in vs)
        if len(set(widths)) != 1:
            raise ValueError(f"blocked RHS block counts differ: {widths}")
        return tuple(stack([v[b] for v in vs]) for b in range(widths[0]))
    return stack(vs)


class TokenBudgetBatcher:
    """FIFO coalescing of solve requests under a token budget."""

    def __init__(self, *, max_tokens: int = 4096, max_requests: int = 16,
                 bucket: bool = True, oversize: str = "split"):
        if max_tokens < 1 or max_requests < 1:
            raise ValueError("max_tokens and max_requests must be >= 1")
        if oversize not in ("split", "reject"):
            raise ValueError(f"oversize must be 'split' or 'reject', "
                             f"got {oversize!r}")
        self.max_tokens = int(max_tokens)
        self.max_requests = int(max_requests)
        self.bucket = bool(bucket)
        self.oversize = oversize
        self._queue: List[SolveRequest] = []
        self._uid = itertools.count()

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def pending_tokens(self) -> int:
        return sum(r.tokens for r in self._queue)

    def submit(self, v, *, damping: float, tokens: int = 1, rows=None,
               payload=None, uid: Optional[int] = None,
               tenant: Optional[str] = None,
               trace: Optional[str] = None) -> SolveRequest:
        """Enqueue one request; returns the (uid-stamped) request object."""
        tokens = max(int(tokens), 1)
        if tokens > self.max_tokens and self.oversize == "reject":
            raise ValueError(
                f"request of {tokens} tokens exceeds the {self.max_tokens}-"
                f"token budget (oversize='reject'; use oversize='split' to "
                f"admit oversized requests in solo microbatches)")
        req = SolveRequest(
            uid=next(self._uid) if uid is None else uid, v=v,
            damping=float(damping), tokens=tokens, rows=rows, payload=payload,
            tenant=None if tenant is None else str(tenant),
            trace=None if trace is None else str(trace))
        self._queue.append(req)
        return req

    def queue_stats(self, now: Optional[float] = None) -> dict:
        """Queue depth, pending tokens, and oldest-request age (seconds,
        against ``now`` on the clock that stamped ``t_submit``)."""
        stamped = [r.t_submit for r in self._queue if r.t_submit > 0.0]
        oldest = 0.0
        if stamped and now is not None:
            oldest = max(0.0, now - min(stamped))
        return {"depth": len(self._queue),
                "pending_tokens": self.pending_tokens,
                "oldest_age_s": oldest}

    def select(self, upto: Optional[int] = None
               ) -> Tuple[List[int], Optional[int]]:
        """The queue head's microbatch among the first ``upto`` queued
        requests (all by default): the indices it takes, and the index of
        the request that closes it by the budget — the last one taken once
        ``max_requests`` or the whole ``max_tokens`` is reached, or the
        first of its tenant that would overflow ``max_tokens`` — or None
        while a later request of its tenant could still join it."""
        limit = len(self._queue) if upto is None \
            else min(int(upto), len(self._queue))
        if not limit:
            return [], None
        tenant = self._queue[0].tenant
        take, tokens = [], 0
        for i in range(limit):
            nxt = self._queue[i]
            if nxt.tenant != tenant:
                continue
            if take and tokens + nxt.tokens > self.max_tokens:
                return take, i
            take.append(i)
            tokens += nxt.tokens
            if len(take) == self.max_requests or tokens >= self.max_tokens:
                return take, i
        return take, None

    def next_microbatch(self, upto: Optional[int] = None
                        ) -> Optional[Microbatch]:
        """Coalesce the queue head into one microbatch (None when empty);
        ``upto``: only the first ``upto`` queued requests may join."""
        idx, _ = self.select(upto)
        if not idx:
            return None
        take = [self._queue[i] for i in idx]
        for i in reversed(idx):
            self._queue.pop(i)
        tenant = take[0].tenant
        tokens = sum(r.tokens for r in take)
        k = len(take)
        pad_to = _bucket_width(k, self.max_requests) if self.bucket else k
        V = _stack_columns([r.v for r in take], pad_to)
        lams = torch.tensor([r.damping for r in take] + [1.0] * (pad_to - k),
                            dtype=torch.float32)
        return Microbatch(requests=tuple(take), V=V, dampings=lams,
                          tokens=tokens, tenant=tenant)

    def drain(self) -> Iterator[Microbatch]:
        """Yield microbatches until the queue is empty."""
        while True:
            mb = self.next_microbatch()
            if mb is None:
                return
            yield mb
