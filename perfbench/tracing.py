"""The traced run: a ``torch.profiler`` capture of the measured window and
its reduction to device time by layer.

The profiler records the card's side only (its operations, and the
runtime and driver calls that launched them): recording every PyTorch
operation on the host as well slows a busy server's host loop several
times over. The harness labels its own calls into each layer itself
(``Capture.span``, see ``Layers``), on the clock the profiler's records
are stamped with (Unix nanoseconds). A device operation belongs to the
innermost label that was open on the host when the operation was
launched (the launch's call shares the operation's correlation id).
Idle time is the part of the window in which no device operation ran,
and each idle stretch is put down to the innermost label open on the
host at its start.

The capture is read from the profiler's raw records
(``kineto_results.events()``), not from its function-event tree, which
takes minutes to build for a window of a busy server.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import re
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

__all__ = ["Capture", "IncompleteProfile", "Layers", "TraceData",
           "kernel_family"]

WINDOW = "pb.window"
# the host's calls that put work on the card (runtime and driver API)
_LAUNCH = re.compile(r"^cu(da)?[A-Z]")
# device records that are waits, not operations
_NOT_OPS = ("Sync", "Wait Event")


class IncompleteProfile(RuntimeError):
    """The capture lacks device operations that the program launched."""


# kernel families by a part of their (demangled) names; the launch
# counters of repro_torch count the same families
FAMILIES = {
    "gram": ("gram_tc_kernel", "gram_partial_kernel"),
    "cholesky": ("cholesky_kernel",),
    "trisolve": ("trisolve_kernel",),
    "ngd_apply": ("ngd_apply_kernel",),
    "cross": ("cross_partial_kernel", "cross_mma_kernel"),
    "serve_apply": ("serve_apply_kernel",),
    "cholupdate": ("cholupdate_kernel",),
}


def kernel_family(name: str) -> Optional[str]:
    for fam, parts in FAMILIES.items():
        if any(p in name for p in parts):
            return fam
    return None


def short_name(name: str, width: int = 72) -> str:
    """A kernel's name without ``void `` and its argument list."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch in "<[":
            depth += 1
        elif ch in ">]":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:width]


class TraceData:
    """Device operations of one window, with the host label each was
    launched under, and the host's labelled ranges."""

    def __init__(self, device_ops, ranges, window):
        # device_ops: [(name, start_ns, dur_ns, label)]
        self.device_ops = device_ops
        self.ranges = ranges      # [(start_ns, end_ns, path, parent)]
        self.window = window                  # (start_ns, end_ns)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def _intervals(self) -> List[Tuple[int, int]]:
        w0, w1 = self.window
        iv = sorted((max(s, w0), min(s + d, w1))
                    for _, s, d, _ in self.device_ops)
        merged: List[List[int]] = []
        for a, b in iv:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @functools.cached_property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._intervals()) / 1e9

    def seconds_under(self, *labels: str) -> float:
        """Device seconds of the operations launched while any of
        ``labels`` was open on the host (at any depth)."""
        want = set(labels)
        return sum(d for _, _, d, lab in self.device_ops
                   if lab is not None and want & set(lab.split("/"))) / 1e9

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = defaultdict(int)
        for name, _, _, _ in self.device_ops:
            fam = kernel_family(name)
            if fam is not None:
                out[fam] += 1
        return dict(out)

    def top_ops(self, limit: int = 10) -> List[list]:
        by: Dict[str, int] = defaultdict(int)
        for name, _, d, _ in self.device_ops:
            by[short_name(name)] += d
        top = sorted(by.items(), key=lambda kv: -kv[1])[:limit]
        return [[k, v / 1e9] for k, v in top]

    def idle_gaps(self, limit: int = 10) -> List[list]:
        """Idle seconds of the window by the host label open at the start
        of each idle stretch, the largest first."""
        w0, w1 = self.window
        gaps, t = [], w0
        for a, b in self._intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if w1 > t:
            gaps.append((t, w1))
        starts = [r[0] for r in self.ranges]
        by: Dict[str, int] = defaultdict(int)
        for a, b in gaps:
            by[_innermost(self.ranges, starts, a) or "host"] += b - a
        top = sorted(by.items(), key=lambda kv: -kv[1])[:limit]
        return [[k, v / 1e9] for k, v in top]


def _innermost(ranges, starts, t) -> Optional[str]:
    """The path of the innermost range open at ``t``. Ranges are sorted by
    start and properly nested (one host thread), so the innermost one is
    the last range opened before ``t`` or one of its ancestors."""
    j = bisect.bisect_right(starts, t) - 1
    while j >= 0:
        s, e, path, parent = ranges[j]
        if s <= t < e:
            return path
        j = parent
    return None


def _nest(ranges):
    """(start, end, path, parent index) of each range: its name with its
    enclosing ranges' names, joined by "/" (``pb.flush/pb.fold``), the
    window's own range left out."""
    out, stack = [], []
    for s, e, name in ranges:
        while stack and out[stack[-1]][1] <= s:
            stack.pop()
        parent = stack[-1] if stack else -1
        names = [r for r in (out[parent][2] if parent >= 0 else "",
                             "" if name == WINDOW else name) if r
                 and r != WINDOW]
        out.append((s, e, "/".join(names) or WINDOW, parent))
        stack.append(len(out) - 1)
    return out


class Capture:
    """``with Capture(device) as cap:`` profiles the card (on a CPU, the
    host: there is no card to record) and takes the harness's labels
    (``cap.span(name)``); ``cap.data()`` reduces the capture once it has
    stopped."""

    def __init__(self, device: torch.device):
        self.device = device
        act = torch.profiler.ProfilerActivity
        self.prof = torch.profiler.profile(
            activities=[act.CUDA if device.type == "cuda" else act.CPU])
        self.spans: List[Tuple[int, int, str]] = []

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    @contextlib.contextmanager
    def span(self, name: str):
        t = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((t, time.time_ns(), name))

    def data(self) -> TraceData:
        events = self.prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        launches, device = {}, []
        for e in events:
            name = e.name()
            start, dur = e.start_ns(), e.duration_ns()
            if e.device_type() == cuda:
                # the card's own records: kernels, copies, memsets; not the
                # device side of the harness's labels, nor waits
                if not name.startswith("pb.") and not any(
                        w in name for w in _NOT_OPS):
                    device.append((name, start, dur, e.correlation_id()))
            elif _LAUNCH.match(name):
                launches[e.correlation_id()] = start
        ranges = sorted(self.spans)
        window = next(((a, b) for a, b, n in ranges if n == WINDOW), None)
        if window is None:
            raise IncompleteProfile("the capture holds no window range")
        ranges = _nest(ranges)
        starts = [r[0] for r in ranges]
        ops = []
        for name, s, d, corr in device:
            t = launches.get(corr)
            label = None if t is None else _innermost(ranges, starts, t)
            ops.append((name, s, d, label))
        return TraceData(ops, ranges, window)


class Layers:
    """Labels the harness's calls into the program's layers while a trace
    is taken: ``wrap(owner, attr, label)`` replaces a function of a module
    (or a method of an object) by one that runs inside ``span(label)``
    and counts its calls (with ``shape``, what it records of each);
    ``restore()`` puts every original back. Without a capture nothing is
    replaced."""

    def __init__(self, cap: Optional[Capture]):
        self.cap = cap
        self.calls: Dict[str, List[tuple]] = defaultdict(list)
        self._saved: List[tuple] = []

    def wrap(self, owner, attr: str, label: str,
             shape: Optional[Callable] = None) -> None:
        if self.cap is None:
            return
        fn = getattr(owner, attr)
        calls, span = self.calls[label], self.cap.span

        @functools.wraps(fn)
        def labelled(*args, **kwargs):
            calls.append(() if shape is None else shape(*args, **kwargs))
            with span(label):
                return fn(*args, **kwargs)

        self._saved.append((owner, attr, vars(owner).get(attr, _MISSING)))
        setattr(owner, attr, labelled)

    def restore(self) -> None:
        for owner, attr, orig in reversed(self._saved):
            if orig is _MISSING:
                delattr(owner, attr)
            else:
                setattr(owner, attr, orig)
        self._saved.clear()


_MISSING = object()


def label(cap: Optional[Capture], name: str):
    """``cap.span(name)`` while tracing, else nothing."""
    return cap.span(name) if cap is not None else contextlib.nullcontext()
