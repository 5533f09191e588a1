"""Where the parts of the reference that the port has not reached yet are
queued: ``ROADMAP.md``, queue A. Every refusal message of the port names
its queue through this one table, so a renumbering of the roadmap changes
one place."""
from __future__ import annotations

__all__ = ["QUEUES", "queue"]

QUEUES = {
    "launch": ("A9", "launch tooling"),
}


def queue(key: str) -> str:
    """'ROADMAP A9 (launch tooling)' for ``key`` = 'launch'."""
    label, what = QUEUES[key]
    return f"ROADMAP {label} ({what})"
