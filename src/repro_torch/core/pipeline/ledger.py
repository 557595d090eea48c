"""Signal/flag ledger: the bookkeeping model of put-with-signal state.

The port of the JAX package's ``core/pipeline/ledger.py``.  The paper's
GPU-initiated kernels coordinate through *signals*: every put deposits
data AND bumps a flag on the receiver; consumers acquire the flag before
touching the payload (Alg. 5).  A ``depth``-buffered step pipeline also
needs per-*slot* flags, so that step ``N + depth - 1``'s puts cannot
clobber a buffer step ``N`` still reads: the ring's reuse distance is the
in-flight window ``depth``.

On the card the data dependency itself is carried by stream order (every
exchange of the virtual mesh runs on one CUDA stream; ``put_signal`` and
``fused_pulses`` also raise real arrival words).  What the ledger models
is the *bookkeeping*: which slot's signals were released and acquired,
whether every acquire had a matching release, and whether a release ever
landed on a slot still holding an unconsumed deposit.  Nothing in this
slice makes a release depend on device data, so the counters are
host-side ``int64`` numpy arrays and the ledger adds no device work to a
step.  The slot layout, transitions, invariants and :meth:`summary` are
the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

KINDS = ("fwd", "rev")   # coordinate halo signals / force-return signals

# Deterministic fault injection (:mod:`repro_torch.resilience`): the sites
# an ``inject=True`` engine can arm inside a block, in the reference's
# fault-vector layout.  Entry ``s`` of a fault vector holds the
# block-relative step at which site ``s`` fires (``DISARMED``: it stays
# healthy).  The layout lives here, beside the bookkeeping that
# ``signal_drop`` perturbs, so the pipeline and ``resilience.faults``
# share one definition.
SCAN_FAULT_SITES = ("halo_corrupt", "force_nan", "signal_drop")
FAULT_HALO, FAULT_FORCE, FAULT_DROP = range(len(SCAN_FAULT_SITES))
DISARMED = -1


class LedgerState(NamedTuple):
    """Counters per ledger slot (host ``int64`` arrays)."""

    released: np.ndarray   # put-with-signal deposits
    acquired: np.ndarray   # acquire_wait completions
    clobbers: np.ndarray   # releases onto a still-outstanding slot


@dataclass(frozen=True)
class SignalLedger:
    """Static slot layout for a ``depth``-buffered pipeline.

    One signal per (kind, buffer slot, pulse): ``fwd`` signals gate the
    force pass's reads of received coordinate halos, ``rev`` signals the
    integrator's reads of returned halo forces.  A correctly scheduled
    window keeps every slot's outstanding count in ``{0, 1}`` and the
    clobber counters at zero (see :meth:`window_safe`).  Transitions are
    pure: each returns a new :class:`LedgerState`.
    """

    depth: int       # halo buffer slots (2 = double buffer)
    n_pulses: int    # pulses per exchange direction

    def __post_init__(self):
        if self.depth < 1 or self.n_pulses < 1:
            raise ValueError("depth and n_pulses must be >= 1")

    @property
    def n_slots(self) -> int:
        return len(KINDS) * self.depth * self.n_pulses

    def slot(self, kind: str, buf: int, pulse: int) -> int:
        """Flat index of (kind, buffer slot, pulse)."""
        k = KINDS.index(kind)
        return (k * self.depth + buf % self.depth) * self.n_pulses + pulse

    def init(self) -> LedgerState:
        z = np.zeros((self.n_slots,), np.int64)
        return LedgerState(released=z, acquired=z.copy(), clobbers=z.copy())

    # -- transitions -------------------------------------------------------

    def release(self, st: LedgerState, kind: str, buf: int) -> LedgerState:
        """All of (kind, buf)'s pulse signals fire: puts were issued.

        A release onto a slot whose previous deposit is still unacquired
        is the buffer-clobber hazard the ring guards against; it is
        counted, not blocked (the ledger is a monitor, not a lock)."""
        idx = self._idx(kind, buf)
        outstanding = st.released[idx] - st.acquired[idx]
        clobbers = st.clobbers.copy()
        clobbers[idx] += (outstanding >= 1).astype(np.int64)
        released = st.released.copy()
        released[idx] += 1
        return LedgerState(released, st.acquired, clobbers)

    def release_dropped(self, st: LedgerState, kind: str, buf: int,
                        dropped: bool) -> LedgerState:
        """Injection hook: a put-with-signal whose signal may never land.

        When ``dropped`` the host ledger *skips* the release, so the
        matching acquire drives :meth:`consistent` False and the block's
        health flag trips.  The data transfer still happens, and on the
        card the kernel's own arrival word is still written: a withheld
        word would leave its consumer waiting with no error.  Otherwise
        this is :meth:`release`."""
        return st if dropped else self.release(st, kind, buf)

    def acquire(self, st: LedgerState, kind: str, buf: int) -> LedgerState:
        """All of (kind, buf)'s pulse signals are consumed (acquire_wait)."""
        acquired = st.acquired.copy()
        acquired[self._idx(kind, buf)] += 1
        return LedgerState(st.released, acquired, st.clobbers)

    def _idx(self, kind: str, buf: int) -> np.ndarray:
        return self.slot(kind, buf, 0) + np.arange(self.n_pulses)

    # -- invariants --------------------------------------------------------

    def outstanding(self, st: LedgerState) -> np.ndarray:
        """released - acquired per slot (>= 0 iff causally consistent)."""
        return st.released - st.acquired

    def in_flight(self, st: LedgerState) -> int:
        """Total deposits released but not yet acquired."""
        return int(self.outstanding(st).sum())

    def drained(self, st: LedgerState) -> bool:
        """True iff no deposit is in flight (the epilogue's exit state)."""
        return bool(np.all(self.outstanding(st) == 0))

    def consistent(self, st: LedgerState) -> bool:
        """True iff no signal was ever acquired before its release."""
        return bool(np.all(st.acquired <= st.released))

    def window_safe(self, st: LedgerState) -> bool:
        """True iff no release ever clobbered an outstanding slot."""
        return bool(np.all(st.clobbers == 0))

    def summary(self, st: LedgerState, registry=None,
                prefix: str = "ledger") -> dict:
        """Totals per kind, summed over slots and pulses, plus the
        invariants (the reference's dict, key for key).

        With a :class:`~repro_torch.obs.registry.MetricsRegistry`, also
        publishes them as a ``ledger_summary`` record and ``<prefix>/*``
        gauges, as the reference does."""
        out = {}
        for k, kind in enumerate(KINDS):
            lo = k * self.depth * self.n_pulses
            hi = lo + self.depth * self.n_pulses
            out[kind] = {
                "released": int(st.released[lo:hi].sum()),
                "acquired": int(st.acquired[lo:hi].sum()),
            }
        out["consistent"] = self.consistent(st)
        out["in_flight"] = self.in_flight(st)
        out["clobbers"] = int(st.clobbers.sum())
        out["window_safe"] = self.window_safe(st)
        if registry is not None:
            registry.emit("ledger_summary", depth=self.depth,
                          n_pulses=self.n_pulses, data=out)
            for kind in KINDS:
                registry.gauge(f"{prefix}/{kind}_released").set(
                    out[kind]["released"])
                registry.gauge(f"{prefix}/{kind}_acquired").set(
                    out[kind]["acquired"])
            registry.gauge(f"{prefix}/in_flight").set(out["in_flight"])
            registry.gauge(f"{prefix}/clobbers").set(out["clobbers"])
        return out
