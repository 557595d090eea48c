"""Health monitors, read at block boundaries.

The port of the JAX package's ``resilience/monitors.py``.  The device
side lives in the engine (``MDEngine(health=True)``): a NaN / Inf count
per step over positions, velocities and forces, and a ledger-invariant
flag per pipeline invocation (computed on the host from the ledger),
riding the block metrics the runner reads once a block.  This module is
the host side: :class:`HealthMonitor` scans a block's metrics for those
flags plus an energy spike in the ``pe + ke`` series (corruption that
stays finite), and turns them into typed :class:`HealthEvent`\\ s the
recovery policy consumes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class HealthEvent:
    """One tripped monitor: ``kind`` at global MD step ``step``.

    ``kind`` is one of ``nonfinite`` / ``ledger`` / ``energy_spike``
    (this module) or ``device_loss`` / ``overflow`` (raised by the
    runner's host-side checks); ``value`` is the offending magnitude."""

    kind: str
    step: int
    value: float = 0.0


class HealthMonitor:
    """Scans block-boundary metrics into :class:`HealthEvent` lists.

    ``energy_spike_rel`` is the per-step relative jump in total energy
    (``|dE| > rel * max(|E_prev|, floor)``) treated as corruption; NVE
    drift over one step is orders of magnitude below any sane setting.
    The previous block's last energy seeds the cross-block comparison;
    :meth:`reset` clears it (call after a rollback — the retried block
    re-derives it from the restored state).
    """

    def __init__(self, energy_spike_rel: float = 0.25,
                 energy_floor: float = 1e-3, registry=None):
        self.energy_spike_rel = float(energy_spike_rel)
        self.energy_floor = float(energy_floor)
        self.registry = registry
        self._last_E: Optional[float] = None

    def reset(self):
        """Forget cross-block state (rollback / degrade / reshard)."""
        self._last_E = None

    def check_block(self, metrics: Dict[str, np.ndarray], step0: int
                    ) -> List[HealthEvent]:
        """Scan one block's host-side metrics; returns tripped events.

        ``step0`` is the block's first global step (per-step metric index
        ``i`` is step ``step0 + i``).  Cross-block energy state advances
        only on a clean block — a block that trips anything leaves the
        monitor where it was, so the rolled-back retry is compared
        against the same last-good reference."""
        events: List[HealthEvent] = []

        nf = np.atleast_1d(np.asarray(metrics.get("health/nonfinite", 0)))
        if (nf > 0).any():
            first = int(np.argmax(nf > 0))
            events.append(HealthEvent("nonfinite", step0 + first,
                                      float(nf.max())))

        lv = np.atleast_1d(np.asarray(
            metrics.get("health/led_violation", 0)))
        if (lv > 0).any():
            # ledger scalars are per pipeline invocation, not per step:
            # block granularity is the best resolution available
            events.append(HealthEvent("ledger", step0, float(lv.max())))

        pe, ke = metrics.get("pe"), metrics.get("ke")
        last_E = self._last_E
        if pe is not None and ke is not None:
            E = (np.asarray(pe, np.float64).reshape(-1)
                 + np.asarray(ke, np.float64).reshape(-1))
            prev = self._last_E
            for i, e in enumerate(E):
                if not np.isfinite(e):
                    prev = None        # NaN steps: nonfinite already fired
                    continue
                if prev is not None:
                    scale = max(abs(prev), self.energy_floor)
                    if abs(e - prev) > self.energy_spike_rel * scale:
                        events.append(HealthEvent(
                            "energy_spike", step0 + i,
                            float(abs(e - prev) / scale)))
                        break
                prev = e
            if np.isfinite(E[-1]):
                last_E = float(E[-1])

        if not events:
            self._last_E = last_E
        if self.registry is not None:
            for ev in events:
                self.registry.counter(f"resilience/{ev.kind}").inc()
                self.registry.emit("health_event", event=ev.kind,
                                   step=ev.step, value=ev.value)
        return events
