"""Deterministic fault injection: seeded, replayable fault plans.

The port of the JAX package's ``resilience/faults.py``.  A resilience
layer is only trustworthy if every recovery path can be provoked on
demand: :class:`FaultPlan` is a list of ``(site, step)`` fault specs,
reproducible from a seed (the reference's draws for the same seed), that
the :class:`~repro_torch.resilience.runner.ResilientMDRunner` arms block
by block.

Two families of site:

* **scan sites** (``ledger.SCAN_FAULT_SITES``) perturb a block's steps: a
  NaN'd received halo slab, a NaN'd force output, a dropped
  put-with-signal release.  They are armed through ``MDEngine.run_block``'s
  ``fault_vec`` (block-relative steps).  The host decides which sites
  fire at each step, so a disarmed step runs exactly the operations of
  an ``inject=False`` engine.
* **host sites** fire at block boundaries on the host: a forced
  inner-ladder overflow (a synthetic trip of the engine's overflow
  monitor), a simulated device loss (escalates to ``MDEngine.reshard``)
  and a process kill (exercises the checkpoint auto-resume).

``sticky=True`` faults re-fire every block until their site is disabled:
a rollback cannot outrun them, so the policy must walk to the degrade
rung that removes the faulted component (which then calls
:meth:`FaultPlan.disable_sites`).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.pipeline.ledger import DISARMED, SCAN_FAULT_SITES

HOST_FAULT_SITES = ("inner_overflow", "device_loss", "proc_kill")
ALL_FAULT_SITES = SCAN_FAULT_SITES + HOST_FAULT_SITES


class ResilienceError(RuntimeError):
    """Base of the resilience layer's typed exceptions."""


class HealthTripped(ResilienceError):
    """A health monitor fired and no recovery path was taken."""


class RecoveryExhausted(ResilienceError):
    """Retries and the degrade ladder are both spent."""


class DeviceLost(ResilienceError):
    """Simulated device loss with no spare mesh to reshard onto."""


class ProcessKilled(ResilienceError):
    """Injected host-process kill (the checkpoint auto-resume drill)."""


class WaveTimeout(ResilienceError):
    """A serving wave's decode loop exceeded its per-wave deadline."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One named fault: ``site`` fires at global MD step ``step``.

    Scan sites fire inside the block containing ``step``; host sites
    fire at the boundary before that block.  ``sticky`` faults re-fire
    every subsequent block until the site is disabled."""

    site: str
    step: int
    sticky: bool = False

    def __post_init__(self):
        if self.site not in ALL_FAULT_SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"available: {ALL_FAULT_SITES}")
        if self.step < 0:
            raise ValueError("fault step must be >= 0")


class FaultPlan:
    """Replayable schedule of faults, armed block by block.

    The plan is pure host-side bookkeeping: :meth:`arm_scan` /
    :meth:`overflow_armed` / :meth:`host_pending` report what fires in a
    ``[lo, hi)`` step window, and the runner marks specs fired after the
    block executes (so a rolled-back block re-arms nothing — one-shot
    faults fire exactly once, which is what makes the rollback retry
    converge bitwise)."""

    def __init__(self, specs: Iterable[FaultSpec] = ()):
        self.specs: List[FaultSpec] = list(specs)
        self._fired = [False] * len(self.specs)
        self._disabled: set = set()

    @classmethod
    def from_seed(cls, seed: int, n_steps: int,
                  sites: Sequence[str] = SCAN_FAULT_SITES,
                  n_faults: int = 3) -> "FaultPlan":
        """Seeded plan: ``n_faults`` sites/steps drawn reproducibly."""
        rng = np.random.RandomState(seed)
        specs = [FaultSpec(site=sites[int(rng.randint(len(sites)))],
                           step=int(rng.randint(max(1, n_steps))))
                 for _ in range(n_faults)]
        return cls(specs)

    # -- liveness ----------------------------------------------------------

    def _live(self, i: int) -> bool:
        s = self.specs[i]
        if s.site in self._disabled:
            return False
        return s.sticky or not self._fired[i]

    def _in_window(self, s: FaultSpec, lo: int, hi: int) -> bool:
        if s.sticky:
            return s.step < hi          # re-fires every block from `step`
        return lo <= s.step < hi

    # -- block arming ------------------------------------------------------

    def arm_scan(self, lo: int, hi: int
                 ) -> Tuple[Optional[np.ndarray], List[int]]:
        """The ``fault_vec`` operand for a ``[lo, hi)`` block.

        Returns ``(vector, armed_indices)``; the vector is ``None`` when
        no scan site fires (the block runs fully disarmed).  When two
        specs target the same site in one block, the earliest step wins
        (the other stays pending for a later block)."""
        vec = np.full((len(SCAN_FAULT_SITES),), DISARMED, np.int32)
        armed: List[int] = []
        for i, s in enumerate(self.specs):
            if s.site not in SCAN_FAULT_SITES or not self._live(i) \
                    or not self._in_window(s, lo, hi):
                continue
            k = s.site
            rel = max(0, s.step - lo)
            slot = SCAN_FAULT_SITES.index(k)
            if vec[slot] == DISARMED or rel < vec[slot]:
                vec[slot] = rel
            armed.append(i)
        if not armed:
            return None, []
        return vec, armed

    def overflow_armed(self, lo: int, hi: int) -> Tuple[bool, List[int]]:
        """Does the forced inner-ladder-overflow site fire this block?"""
        armed = [i for i, s in enumerate(self.specs)
                 if s.site == "inner_overflow" and self._live(i)
                 and self._in_window(s, lo, hi)]
        return bool(armed), armed

    def host_pending(self, lo: int, hi: int) -> List[Tuple[int, FaultSpec]]:
        """Device-loss / process-kill specs due before this block runs."""
        return [(i, s) for i, s in enumerate(self.specs)
                if s.site in ("device_loss", "proc_kill") and self._live(i)
                and self._in_window(s, lo, hi)]

    # -- outcome bookkeeping ----------------------------------------------

    def mark_fired(self, indices: Iterable[int]):
        """Record that these specs' faults ran (sticky specs stay live —
        only :meth:`disable_sites` retires them)."""
        for i in indices:
            self._fired[i] = True

    def disable_sites(self, sites: Iterable[str]):
        """Retire whole sites — called when a degrade rung physically
        removes the faulted seam (e.g. the serialized halo backend has no
        put-with-signal to drop)."""
        self._disabled.update(sites)

    # -- introspection -----------------------------------------------------

    @property
    def scan_or_overflow_sites(self) -> bool:
        return any(s.site in SCAN_FAULT_SITES or s.site == "inner_overflow"
                   for s in self.specs)

    def summary(self) -> dict:
        return {
            "specs": [dataclasses.asdict(s) for s in self.specs],
            "fired": [bool(f) for f in self._fired],
            "disabled_sites": sorted(self._disabled),
        }

    def __repr__(self):
        return f"FaultPlan({self.specs!r})"
