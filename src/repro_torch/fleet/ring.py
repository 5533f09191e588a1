"""Consistent-hash ring — tenant → worker placement that survives churn
(torch port of ``repro/fleet/ring.py``; the same arithmetic, so both
packages place every key on the same member).

Each member owns ``vnodes`` points on a 2⁶⁴ circle and a key routes to the
first member point after the key's hash (wrapping). Adding or removing
one member moves only the keys in the arcs it gains or loses — ~1/N of
them in expectation, the vnode count controlling placement variance.
Hashes are ``blake2b`` (stable across processes and Python runs, unlike
``hash()`` under hash randomization), so the dispatcher, its replays and
any failover twin compute identical placements from the same membership.
"""
from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["HashRing"]


def _h64(data: str) -> int:
    return int.from_bytes(hashlib.blake2b(data.encode("utf-8"),
                                          digest_size=8).digest(), "big")


class HashRing:
    """Membership-churn-tolerant key → member mapping.

    Members are opaque string ids (fleet worker ids). ``lookup(key)``
    returns one member; ``lookup(key, avoid=...)`` walks the ring past
    failed members, which preserves every *healthy* assignment during an
    outage.
    """

    def __init__(self, members: Sequence[str] = (), *, vnodes: int = 64):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = int(vnodes)
        self._points: List[Tuple[int, str]] = []   # sorted (hash, member)
        self._keys: List[int] = []                 # hashes, for bisect
        self._members: Dict[str, None] = {}        # insertion-ordered set
        for m in members:
            self.add(m)

    def __len__(self) -> int:
        return len(self._members)

    def __contains__(self, member: str) -> bool:
        return str(member) in self._members

    @property
    def members(self) -> List[str]:
        return list(self._members)

    def add(self, member: str) -> None:
        member = str(member)
        if member in self._members:
            return
        self._members[member] = None
        for i in range(self.vnodes):
            h = _h64(f"{member}#{i}")
            at = bisect.bisect_left(self._keys, h)
            # order hash ties by member id so placement stays deterministic
            while at < len(self._keys) and self._keys[at] == h and \
                    self._points[at][1] < member:
                at += 1
            self._keys.insert(at, h)
            self._points.insert(at, (h, member))

    def remove(self, member: str) -> None:
        member = str(member)
        if member not in self._members:
            return
        del self._members[member]
        keep = [(h, m) for h, m in self._points if m != member]
        self._points = keep
        self._keys = [h for h, _ in keep]

    def lookup(self, key: str, *, avoid: Optional[set] = None
               ) -> Optional[str]:
        """The member owning ``key``: first ring point after the key's
        hash. ``avoid`` (e.g. currently-dead workers) makes the walk skip
        those members — keys on healthy workers don't move, and the
        avoided members' keys spill to their ring successors. Returns
        None when no eligible member exists."""
        if not self._points:
            return None
        avoid = avoid or set()
        start = bisect.bisect_right(self._keys, _h64(str(key)))
        n = len(self._points)
        seen = set()
        for step in range(n):
            member = self._points[(start + step) % n][1]
            if member not in avoid:
                return member
            seen.add(member)
            if len(seen) == len(self._members):
                break
        return None
