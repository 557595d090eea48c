"""Recovery policy: rollback with bounded backoff, then degrade, in order.

The port of the JAX package's ``resilience/policy.py``.  One ordered,
observable :class:`DegradeLadder` of the engine's fallbacks (signal ->
serialized halo backend, pruned -> dense forces, inner-ladder overflow
-> outer ladder, deep window -> depth 2), and a :class:`RecoveryPolicy`
that decides, per tripped monitor, between *rollback* (restore the last
good block and retry, bounded exponential backoff: the transient-fault
path, bitwise because blocks are deterministic), *degrade* (walk the
ladder to the first rung whose triggers match: the persistent-fault
path), *reshard* (device loss -> ``MDEngine.reshard`` onto a spare mesh)
or *fail* (a typed ``RecoveryExhausted``, never a silent divergence).

:class:`Watchdog` is the EWMA step-time straggler monitor the serving
loop and the resilient runner observe.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Set, Tuple


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


@dataclasses.dataclass(frozen=True)
class DegradeRung:
    """One rung: engine-rebuild ``overrides`` that remove a failure mode.

    ``triggers`` — event kinds this rung is the designated fix for (the
    ladder jumps straight to it); ``clears`` — fault *sites* that
    physically cease to exist once the rung is applied (the serialized
    backend has no put-with-signal to drop), reported to the fault plan
    so sticky faults on them retire."""

    name: str
    overrides: dict
    triggers: Tuple[str, ...] = ()
    clears: Tuple[str, ...] = ()


# Ordered cheapest-first: each rung gives up one optimization from the
# paper's stack, never correctness.
DEFAULT_RUNGS: Tuple[DegradeRung, ...] = (
    DegradeRung("serialized_halo", {"backend": "serialized"},
                triggers=("ledger",),
                clears=("signal_drop", "halo_corrupt")),
    DegradeRung("dense_forces", {"force_backend": "dense"},
                triggers=("nonfinite", "energy_spike"),
                clears=("force_nan",)),
    DegradeRung("outer_ladder", {"nstprune": 0},
                triggers=("overflow",),
                clears=("inner_overflow",)),
    DegradeRung("depth2_window", {"pipeline_depth": 2}),
)


class DegradeLadder:
    """Ordered degrade rungs with applied-state tracking."""

    def __init__(self, rungs: Sequence[DegradeRung] = DEFAULT_RUNGS):
        self.rungs = tuple(rungs)
        self.applied: List[DegradeRung] = []

    def next_rung(self, kinds: Set[str]) -> Optional[DegradeRung]:
        """The rung to apply for these event kinds: the first unapplied
        rung that names one of them as a trigger, else the first
        unapplied rung at all (walk the whole ladder before failing)."""
        pending = [r for r in self.rungs if r not in self.applied]
        for r in pending:
            if any(k in r.triggers for k in kinds):
                return r
        return pending[0] if pending else None

    def apply(self, rung: DegradeRung):
        self.applied.append(rung)

    def summary(self) -> dict:
        return {"applied": [r.name for r in self.applied],
                "available": [r.name for r in self.rungs
                              if r not in self.applied]}


@dataclasses.dataclass(frozen=True)
class RecoveryAction:
    """What the policy chose: ``kind`` in rollback / degrade / reshard /
    fail, plus the rung (degrade) or backoff delay (rollback)."""

    kind: str
    rung: Optional[DegradeRung] = None
    backoff_s: float = 0.0


class RecoveryPolicy:
    """Maps (tripped event kinds, retry attempt) to a recovery action."""

    def __init__(self, max_retries: int = 2,
                 backoff_base_s: float = 0.01,
                 backoff_factor: float = 2.0,
                 backoff_cap_s: float = 1.0,
                 ladder: Optional[DegradeLadder] = None):
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self.max_retries = int(max_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_factor = float(backoff_factor)
        self.backoff_cap_s = float(backoff_cap_s)
        self.ladder = ladder if ladder is not None else DegradeLadder()

    def backoff(self, attempt: int) -> float:
        """Bounded exponential backoff for retry ``attempt`` (0-based)."""
        return min(self.backoff_cap_s,
                   self.backoff_base_s * self.backoff_factor ** attempt)

    def decide(self, kinds: Set[str], attempt: int) -> RecoveryAction:
        if "device_loss" in kinds:
            return RecoveryAction("reshard")
        if attempt < self.max_retries:
            return RecoveryAction("rollback",
                                  backoff_s=self.backoff(attempt))
        rung = self.ladder.next_rung(kinds)
        if rung is not None:
            return RecoveryAction("degrade", rung=rung)
        return RecoveryAction("fail")
