"""Optional ``torch.profiler`` capture hooks around the coalesced solve
(the port of ``repro/obs/profile.py``, which wraps ``jax.profiler``).

Kernel-level drill-down for when the span tracer says "device solve" is
the slow stage but not why. ``ProfileHooks(log_dir)`` records CUDA and
CPU activities when a card is present (CPU only otherwise) from
``start()`` to ``stop()`` and writes one Chrome trace,
``<log_dir>/trace_<pid>.json``. With ``log_dir=None`` every method is a
no-op, so the serving hot path carries a single ``if`` when profiling
is off.
"""

from __future__ import annotations

import contextlib
import os

__all__ = ["ProfileHooks"]


class ProfileHooks:
    """Gated wrapper over ``torch.profiler.profile`` + per-solve labels.

    ``step()`` wraps one solve in a ``record_function`` range named
    ``coalesced_solve`` (with the step number when given), so the solves
    line up in the trace viewer. ``trace_path`` is the file ``stop()``
    wrote (None until then).
    """

    def __init__(self, log_dir: str | None = None) -> None:
        self.log_dir = log_dir
        self.trace_path: str | None = None
        self._prof = None

    def start(self) -> None:
        if self.log_dir is None or self._prof is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()

    def stop(self) -> None:
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, f"trace_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        self.trace_path = path

    def step(self, name: str = "coalesced_solve", step: int | None = None):
        """Context manager labelling one solve; no-op when inactive."""
        if self._prof is None:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name if step is None else f"{name}#{step}")
