"""Fault-tolerance utilities for the train/serve drivers: a copy of
``repro.ft.failures`` (pure Python, so the port needs no JAX).

On a real cluster these wrap the process group and the platform's
preemption notice; the logic (deadlines, restart decisions, elastic
re-mesh) is host-side Python and is exercised by unit tests.

  * PreemptionGuard — converts SIGTERM into a 'checkpoint then exit' flag
    checked once per step (the usual preemption contract).
  * StragglerMonitor — per-step deadline tracking with an EWMA baseline;
    marks steps exceeding ``threshold x`` the moving average, and exposes
    a should_rebalance() signal after K consecutive slow steps (the driver
    responds by shrinking the mesh / excluding the slow host).
  * RestartManager — bounded-retry restore-from-latest loop around a step
    function; used by launch/train.py.
  * elastic_remesh — recompute mesh + shardings for a smaller/larger
    device set (restore path re-shards via checkpoint.restore).
"""
from __future__ import annotations

import dataclasses
import signal
import time


class PreemptionGuard:
    def __init__(self, sig=signal.SIGTERM):
        self._requested = False
        try:
            self._prev = signal.signal(sig, self._handler)
        except ValueError:  # not in main thread (tests)
            self._prev = None

    def _handler(self, signum, frame):
        self._requested = True

    @property
    def preempted(self) -> bool:
        return self._requested

    def request(self):  # for tests / manual drills
        self._requested = True


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 2.0      # step is 'slow' if > threshold * ewma
    ewma_alpha: float = 0.1
    rebalance_after: int = 3    # consecutive slow steps before remesh signal

    def __post_init__(self):
        self._ewma: float | None = None
        self._consecutive_slow = 0
        self.slow_steps: list[tuple[int, float]] = []
        self._t0: float | None = None
        self._step = 0

    def start_step(self, step: int):
        self._step = step
        self._t0 = time.perf_counter()

    def end_step(self) -> bool:
        """Returns True if this step was a straggler."""
        dt = time.perf_counter() - self._t0
        slow = self._ewma is not None and dt > self.threshold * self._ewma
        if self._ewma is None:
            self._ewma = dt
        else:
            self._ewma = (1 - self.ewma_alpha) * self._ewma + self.ewma_alpha * dt
        if slow:
            self.slow_steps.append((self._step, dt))
            self._consecutive_slow += 1
        else:
            self._consecutive_slow = 0
        return slow

    def observe(self, step: int, duration_s: float) -> bool:
        """Deterministic variant for tests / offline traces."""
        self._step = step
        slow = self._ewma is not None and duration_s > self.threshold * self._ewma
        if self._ewma is None:
            self._ewma = duration_s
        else:
            self._ewma = (1 - self.ewma_alpha) * self._ewma \
                + self.ewma_alpha * duration_s
        if slow:
            self.slow_steps.append((step, duration_s))
            self._consecutive_slow += 1
        else:
            self._consecutive_slow = 0
        return slow

    def should_rebalance(self) -> bool:
        return self._consecutive_slow >= self.rebalance_after


class RestartManager:
    """Retry loop: run step_fn; on failure restore from latest checkpoint
    and continue, up to max_restarts."""

    def __init__(self, max_restarts: int = 3):
        self.max_restarts = max_restarts
        self.restarts = 0

    def run(self, total_steps: int, step_fn, restore_fn, start_step: int = 0):
        """step_fn(step) -> None may raise; restore_fn() -> resume step."""
        step = start_step
        while step < total_steps:
            try:
                step_fn(step)
                step += 1
            except Exception:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                step = restore_fn()
        return step


def elastic_remesh(num_devices: int, *, multi_pod: bool | None = None):
    """Largest (data, model) mesh <= num_devices with model axis fixed at
    min(16, devices): the shrink-after-failure policy. Returns mesh shape."""
    import math

    model = min(16, num_devices)
    data = num_devices // model
    if multi_pod and data >= 32:
        return (data // 16, 16, model)
    return (data, model)
