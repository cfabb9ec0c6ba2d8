"""Straggler / hang watchdog for the training loop.

At 1000+ nodes, slow hosts (thermal throttling, failing HBM, network
brownout) show up as step-time outliers long before they hard-fail.  The
watchdog keeps an EMA of step times, flags steps beyond ``threshold`` x
EMA, and escalates after ``patience`` consecutive outliers (the launcher
then checkpoints and requests a reschedule rather than dragging the whole
ring at straggler speed).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class StragglerWatchdog:
    threshold: float = 2.5          # x EMA counts as an outlier
    patience: int = 5               # consecutive outliers before escalation
    ema_decay: float = 0.9
    warmup_steps: int = 3           # compile/first-touch steps ignored
    on_escalate: Optional[Callable[[str], None]] = None

    def __post_init__(self):
        self.ema: Optional[float] = None
        self.consecutive = 0
        self.outliers: List[int] = []
        self._seen = 0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.monotonic()

    def stop(self, step: int) -> float:
        assert self._t0 is not None, "start() not called"
        dt = time.monotonic() - self._t0
        self._t0 = None
        self.record(step, dt)
        return dt

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step is an outlier."""
        self._seen += 1
        if self._seen <= self.warmup_steps:
            return False
        if self.ema is None:
            self.ema = dt
            return False
        outlier = dt > self.threshold * self.ema
        if outlier:
            self.outliers.append(step)
            self.consecutive += 1
            if self.consecutive >= self.patience and self.on_escalate:
                self.on_escalate(
                    f"step {step}: {self.consecutive} consecutive outliers "
                    f"(last {dt:.3f}s vs EMA {self.ema:.3f}s)")
                self.consecutive = 0
        else:
            self.consecutive = 0
            self.ema = self.ema_decay * self.ema + (1 - self.ema_decay) * dt
        return outlier
