"""Step-time straggler monitor (a copy of the reference's ``Watchdog``).

The recovery policy and degrade ladder of the reference's
``resilience/policy.py`` come with the MD resilience work.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass
class Watchdog:
    """EWMA step-time monitor with a straggler callback."""
    alpha: float = 0.2
    threshold: float = 3.0
    warmup: int = 3
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    ewma: float = 0.0
    n: int = 0
    events: int = 0

    def observe(self, step: int, dt: float):
        if self.n >= self.warmup and self.ewma > 0 and \
                dt > self.threshold * self.ewma:
            self.events += 1
            if self.on_straggler is not None:
                self.on_straggler(step, dt, self.ewma)
        self.ewma = dt if self.n == 0 else \
            (1 - self.alpha) * self.ewma + self.alpha * dt
        self.n += 1
