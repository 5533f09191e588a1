"""Fault-tolerant training supervisor (port of ``repro/launch/supervisor.py``).

The supervisor owns the restart loop:

* the train loop checkpoints every ``ckpt_every`` steps (atomic, keep-k;
  ``repro_torch.checkpoint``);
* any exception inside the loop (device loss, injected failure, OOM) is
  caught, the process state is discarded, and the loop restarts from the
  latest checkpoint — bounded by ``max_restarts``;
* a **straggler watchdog** tracks per-step wall time against a rolling
  median and reports steps slower than ``straggler_factor``× the median
  (on a fleet this feeds the scheduler's replace-node decision; here it
  feeds the report so tests can assert on it);
* failure injection for tests: ``inject_failure_at`` raises mid-run.

A step's wall time is taken on the host clock around ``step_fn``; a step
function that leaves work queued on the card is timed at its enqueue.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Optional

from repro_torch.checkpoint import checkpoint as ckpt

__all__ = ["SupervisorConfig", "run_supervised", "StragglerWatchdog",
           "InjectedFailure"]


class InjectedFailure(RuntimeError):
    pass


class StragglerWatchdog:
    def __init__(self, factor: float = 3.0, window: int = 32):
        self.factor = factor
        self.window = window
        self.times: list[float] = []
        self.straggler_steps: list[int] = []

    def observe(self, step: int, dt: float):
        if len(self.times) >= 8:
            med = statistics.median(self.times[-self.window:])
            if dt > self.factor * med:
                self.straggler_steps.append(step)
        self.times.append(dt)


@dataclasses.dataclass
class SupervisorConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    max_restarts: int = 3
    straggler_factor: float = 3.0
    inject_failure_at: Optional[int] = None   # tests: raise at this step


def run_supervised(cfg: SupervisorConfig, *, init_state: Callable,
                   step_fn: Callable, save_state: Callable,
                   restore_state: Callable):
    """Generic supervised loop.

    init_state() -> state                         (fresh start)
    step_fn(state, step) -> (state, metrics)      (one training step)
    save_state(dir, step, state)                  (checkpoint)
    restore_state(dir, step) -> state             (resume)

    Returns (state, report) where report covers restarts/stragglers.
    """
    watchdog = StragglerWatchdog(cfg.straggler_factor)
    restarts = 0
    armed = cfg.inject_failure_at is not None

    while True:
        last = ckpt.latest_step(cfg.ckpt_dir)
        if last is not None:
            state, start = restore_state(cfg.ckpt_dir, last), last + 1
        else:
            state, start = init_state(), 0
        try:
            for step in range(start, cfg.total_steps):
                if armed and step == cfg.inject_failure_at:
                    armed = False                  # fail exactly once
                    raise InjectedFailure(f"injected at step {step}")
                t0 = time.time()
                state, _ = step_fn(state, step)
                watchdog.observe(step, time.time() - t0)
                if (step + 1) % cfg.ckpt_every == 0 \
                        or step + 1 == cfg.total_steps:
                    save_state(cfg.ckpt_dir, step, state)
            report = {"restarts": restarts,
                      "stragglers": watchdog.straggler_steps,
                      "completed": True}
            return state, report
        except Exception as e:                     # noqa: BLE001
            # the restart boundary: any failure of a step restores
            restarts += 1
            if restarts > cfg.max_restarts:
                raise RuntimeError(
                    f"exceeded max_restarts={cfg.max_restarts}") from e
            state = None                           # free it before restoring
