"""Pulse schedules for staged (eighth-shell style) halo exchange.

Terminology follows the paper (§2.2):
  * *staged communication* — boundary data is forwarded through intermediate
    ranks rather than sent directly to all final consumers,
  * *communication phases* — the sequential z, then y, then x sweeps,
  * *pulses* — the per-dimension communication steps within a phase.

The **global pulse order** concatenates dimensions in Z -> Y -> X order
(paper §5.1), omitting dimensions not present in the current decomposition.
``firstDependentPulse`` encodes the forwarding dependency: pulse ``y0``
forwards data received by ``z0``, pulse ``x0`` forwards data received by
``y0`` (and transitively ``z0``).

The *fused* schedule (paper Alg. 3/4) partitions each pulse's payload at
``depOffset`` into an **independent** part (locally owned data, sent
immediately) and a **dependent** part (data received by earlier pulses,
sent as soon as that pulse's signal fires).  The exchange realizes this as
*phases of concurrent region transfers*: phase ``p`` carries every halo
region whose forwarding depth is ``p`` (see :mod:`repro_torch.core.halo`).

Pure Python, a copy of the JAX package's schedule module: the port keeps
its own so that it never imports the reference.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class Pulse:
    """One communication step along one decomposition dimension.

    Mirrors the paper's ``PulseData`` metadata (minus the device pointers):
    the send/recv ranks are implied by a neighbour shift along
    ``axis_name``; ``width`` is the halo width in grid
    elements (or the per-pulse atom capacity for the MD index-map path).

    With more than one pulse per dimension (GROMACS' two-pulse case) the
    dimension's halo of total width ``W`` is split across its pulses:
    ``offset`` is this pulse's start row within the dim's halo, so pulse
    ``k`` of dim ``d`` ships slab rows ``[offset, offset + width)`` of the
    sender's (extended) block along ``d``.
    """

    index: int            # position in the global pulse order
    dim: int              # spatial dimension this pulse sweeps (0 = Z-like)
    axis_name: str        # mesh axis name used for the ppermute
    width: int            # this pulse's halo width in elements along `dim`
    offset: int = 0       # start row within the dim's total halo
    dim_pulse: int = 0    # position among this dim's pulses
    n_dim_pulses: int = 1  # total pulses along this dim

    @property
    def first_dependent_pulse(self) -> Optional[int]:
        """Index of the earliest pulse whose data this pulse forwards.

        In the single-pulse-per-dim case this is simply the previous pulse
        in global order (paper §5.1: firstDependentPulse(z0)=none;
        firstDependentPulse(y0)=z0; firstDependentPulse(x0)=y0).  Later
        pulses of the same dim forward data only when their slab reaches
        into rows received by the dim's earlier pulses, which also resolves
        to the previous pulse in global order.
        """
        return None if self.index == 0 else self.index - 1


@dataclass(frozen=True)
class PulseSchedule:
    """Global pulse order ``[Z.., Y.., X..]`` plus fused-phase bookkeeping."""

    pulses: Tuple[Pulse, ...]
    axis_names: Tuple[str, ...]   # one mesh axis per decomposition dim
    widths: Tuple[int, ...]       # TOTAL halo width per decomposition dim
    pulses_per_dim: Tuple[int, ...] = ()   # () = one pulse per dim

    def __post_init__(self):
        if not self.pulses_per_dim:
            object.__setattr__(self, "pulses_per_dim",
                               (1,) * len(self.axis_names))

    def dim_pulses(self, d: int) -> Tuple[Pulse, ...]:
        """This dim's pulses in within-dim (offset-ascending) order."""
        return tuple(p for p in self.pulses if p.dim == d)

    @property
    def ndim(self) -> int:
        return len(self.axis_names)

    @property
    def total_pulses(self) -> int:
        return len(self.pulses)

    # ---- fused-phase structure -------------------------------------------------
    #
    # Halo *regions* are indexed by the subset S of dimensions they extend
    # into.  Region S is received from the +max(S) neighbor, which in turn
    # assembled it from region S \ {max(S)} — i.e. the forwarding depth of
    # region S is |S| - 1.  The fused schedule sends, in phase p, every
    # region with |S| == p + 1; all transfers within a phase are mutually
    # independent (the paper's "independent data" for p == 0, and exactly
    # the per-pulse dependent slices for p >= 1).

    def regions(self) -> Tuple[Tuple[int, ...], ...]:
        """All non-empty dimension subsets, sorted by (depth, dims)."""
        dims = range(self.ndim)
        out = []
        for r in range(1, self.ndim + 1):
            out.extend(itertools.combinations(dims, r))
        return tuple(out)

    def phase_of(self, region: Tuple[int, ...]) -> int:
        return len(region) - 1

    def forward_phases(self) -> Tuple[Tuple[Tuple[int, ...], ...], ...]:
        """Regions grouped by fused phase, shallow -> deep (coordinates)."""
        groups: list[list[Tuple[int, ...]]] = [[] for _ in range(self.ndim)]
        for region in self.regions():
            groups[self.phase_of(region)].append(region)
        return tuple(tuple(g) for g in groups)

    def reverse_phases(self) -> Tuple[Tuple[Tuple[int, ...], ...], ...]:
        """Regions grouped by fused phase, deep -> shallow (forces).

        The force halo (paper Alg. 6) walks the dependency chain backwards:
        the deepest (corner) contributions must land before the faces are
        returned, hence phase 0 carries regions of maximal depth.
        """
        return tuple(reversed(self.forward_phases()))

    def serialized_order(self) -> Tuple[Pulse, ...]:
        """MPI-like order: one full (own + forwarded) slab per pulse."""
        return self.pulses

    def dependent_fraction(self, local_shape: Sequence[int]) -> float:
        """Fraction of total halo volume that is forwarding-dependent.

        This is the napkin-math quantity behind the fused design: only this
        fraction of the exchanged bytes sits on a chained critical path; the
        rest moves concurrently in phase 0.
        """
        total = 0
        dependent = 0
        for region in self.regions():
            vol = 1
            for d in range(self.ndim):
                vol *= self.widths[d] if d in region else local_shape[d]
            total += vol
            if len(region) > 1:
                dependent += vol
        return dependent / total if total else 0.0


def split_width(width: int, n_pulses: int) -> Tuple[int, ...]:
    """Balanced per-pulse widths for one dim (GROMACS-style, wide first)."""
    base, rem = divmod(width, n_pulses)
    return tuple(base + (1 if k < rem else 0) for k in range(n_pulses))


def make_schedule(axis_names: Sequence[str], widths: Sequence[int],
                  pulses_per_dim: Optional[Sequence[int]] = None
                  ) -> PulseSchedule:
    """Build the global pulse order [Z.., Y.., X..].

    GROMACS supports up to two pulses per dimension; (paper §2.2) in
    GPU-resident runs with DLB disabled the pulse count per dimension is
    "almost always one", which is the default here.  ``pulses_per_dim``
    opts into the multi-pulse case: dim ``d``'s total halo ``widths[d]`` is
    split into ``pulses_per_dim[d]`` balanced slabs, each shipped by its
    own pulse at its own ``offset`` (within-dim pulses appear consecutively
    in the global order, so staged forwarding semantics are preserved).
    """
    if len(axis_names) != len(widths):
        raise ValueError("axis_names and widths must have equal length")
    if not axis_names:
        raise ValueError("need at least one decomposition dimension")
    widths = tuple(int(w) for w in widths)
    if pulses_per_dim is None:
        pulses_per_dim = (1,) * len(axis_names)
    pulses_per_dim = tuple(int(n) for n in pulses_per_dim)
    if len(pulses_per_dim) != len(axis_names):
        raise ValueError("pulses_per_dim and axis_names must have equal "
                         "length")
    pulses = []
    for d, (name, w, np_) in enumerate(zip(axis_names, widths,
                                           pulses_per_dim)):
        if np_ < 1:
            raise ValueError(f"dim {d}: need at least one pulse, got {np_}")
        if w == 0:
            np_ = 1           # width-0 dims degrade to one no-op pulse
        elif np_ > w:
            raise ValueError(f"dim {d}: {np_} pulses cannot split a "
                             f"width-{w} halo")
        off = 0
        for k, wk in enumerate(split_width(w, np_)):
            pulses.append(Pulse(index=len(pulses), dim=d, axis_name=name,
                                width=wk, offset=off, dim_pulse=k,
                                n_dim_pulses=np_))
            off += wk
    return PulseSchedule(pulses=tuple(pulses),
                         axis_names=tuple(axis_names), widths=widths,
                         pulses_per_dim=pulses_per_dim)
