"""Static comm-schedule verifier: prove put-with-signal safety pre-trace.

The port's copy of the JAX package's ``analysis/schedule_verifier.py``,
with the same checks, messages and verdicts.  Where it speaks of the
step-boundary ``optimization_barrier``, the port's counterpart is program
order: its step pipeline is a Python loop issuing every step's work on
one CUDA stream.

The paper's GPU-initiated halo exchange stands on its signal protocol: a
``nvshmem_put_signal_nbi`` that lands on a still-outstanding buffer slot,
or an ``acquire_wait`` that returns before the matching deposit, corrupts
trajectories silently.  The runtime :class:`~repro_torch.core.pipeline.ledger.
SignalLedger` *counts* those violations after they happen; this module
decides them **before a single step is traced**, by symbolically replaying
the exact release/acquire event sequence :class:`~repro_torch.core.pipeline.
StepPipeline` emits for a configuration:

* mode ``"off"``   — per step: release fwd -> acquire fwd -> release rev
  -> acquire rev on the single slot (the serialized reference chain);
* mode ``"double_buffer"`` (depth ``d``, acquire skew ``window`` ``w``) —
  the prologue fills slot 0 and releases its force-return at fill time;
  step ``k`` acquires the deposit of step ``k - w`` from the ring, then
  runs its own forward half and releases its own slot ``k % d``; the
  epilogue drains the last ``w`` outstanding slots;
* rolling-prune sub-blocks (``nstprune``) — the block splits into
  fresh-ledger ``run_local`` chains, each preceded by the prune's own
  (immediately-acquired) coordinate exchange;
* ``overlap_rebin`` — the rebin/migration gather and (pruned backends)
  the boundary prune fused after the block's final region.

The deterministic event sequence is replayed with exhaustive slot-state
enumeration: every reachable ``(released, acquired)`` counter state of
every ``(kind, slot)`` signal is visited in program order, flagging
``SLOT_CLOBBER``, ``ACQUIRE_BEFORE_RELEASE`` and ``DRAIN_INCOMPLETE``
exactly where the runtime ledger would count them.  On top of the replay
a happens-before DAG (per-step dataflow chains, the step-boundary
``optimization_barrier`` pins, release->acquire signal edges) checks that
every slot reuse is *ordered* after the previous deposit's acquire —
``UNORDERED_REUSE`` catches schedules that only pass the linear replay by
luck (e.g. skew-2 windows with the step barrier dropped).

The whole analysis is pure Python over :mod:`repro_torch.core.schedule`,
so it runs at import speed and is promoted to a
build-time gate in ``StepPipeline.build`` / ``MDEngine.__init__``: unsafe
configurations are rejected with the counterexample event trace in the
error, with ``verify="warn"`` as the experimentation escape hatch.
"""
from __future__ import annotations

import functools
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.schedule import make_schedule

# kept in lock-step with repro_torch.core.pipeline.PIPELINE_MODES (asserted
# by tests); duplicated here so the analyzer imports no torch module
MODES = ("off", "double_buffer")
VERIFY_MODES = ("error", "warn", "off")

RELEASE, ACQUIRE = "release", "acquire"


class ConfigError(ValueError):
    """A configuration the verifier can reject without replaying events."""


class ScheduleVerificationError(ValueError):
    """An unsafe schedule, rejected at build time with its counterexample.

    ``report`` carries the full :class:`ScheduleReport` (verdict,
    violations, event segments) for programmatic inspection.
    """

    def __init__(self, message: str, report: "ScheduleReport"):
        super().__init__(message)
        self.report = report


# --------------------------------------------------------------------------
# event model
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class CommEvent:
    """One signal transition of the put-with-signal protocol.

    A ``release`` covers all of one ``(kind, slot)``'s pulse signals firing
    (puts issued at fill time); an ``acquire`` covers the matching
    ``acquire_wait`` completions right before the consumer reads — the
    same granularity as ``SignalLedger.release``/``acquire``.  ``step`` is
    the program step at which the event executes; ``deposit`` the step
    whose payload it concerns.  ``ledgered=False`` marks exchanges the
    runtime issues outside ledger bookkeeping (rolling-prune / rebin
    boundary traffic, self-synchronizing by construction).
    """

    op: str                 # "release" | "acquire"
    kind: str               # "fwd" | "rev"
    slot: int               # buffer ring index
    step: int               # program step executing the event
    deposit: int            # step whose deposit this event concerns
    site: str               # serial|prologue|window|drain|prune|rebin
    ledgered: bool = True

    def describe(self) -> str:
        dep = ("" if self.deposit == self.step
               else f" (deposit of step {self.deposit})")
        tag = "" if self.ledgered else " [unledgered]"
        return (f"{self.op:<7} {self.kind} slot={self.slot} "
                f"@step {self.step:<3} {self.site}{dep}{tag}")


@dataclass(frozen=True)
class EventSegment:
    """One fresh-ledger ``run_local`` invocation's event sequence."""

    label: str
    events: Tuple[CommEvent, ...]


@dataclass(frozen=True)
class Violation:
    """One protocol violation, anchored to its event index."""

    code: str               # SLOT_CLOBBER | ACQUIRE_BEFORE_RELEASE |
    #                         DRAIN_INCOMPLETE | UNORDERED_REUSE
    segment: str
    index: int              # offending event index within the segment
    message: str
    trace: Tuple[str, ...]  # counterexample event trace (formatted lines)


# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ScheduleConfig:
    """Everything that determines the emitted release/acquire sequence.

    ``window`` is the acquire skew in steps: step ``k``'s force-return
    deposit is consumed at step ``k + window``.  ``StepPipeline`` always
    emits skew 1 (the integrator's serial physics chain forbids more);
    larger values describe deeper-lag schedules — an *over-deep window*
    ``window > depth`` reuses a slot before its deposit drains and is
    exactly the hazard the ring exists to prevent.  ``step_barrier``
    models the per-step ``optimization_barrier`` pin; dropping it only
    affects the happens-before (reordering) analysis, not the replay.
    """

    mode: str = "double_buffer"
    depth: int = 2
    n_steps: int = 8
    window: int = 1
    n_pulses: int = 1
    nstprune: int = 0
    overlap_rebin: bool = False
    backend: str = "fused"          # halo backend (metadata, kept in report)
    force_backend: str = "dense"    # decides the boundary-prune traffic
    step_barrier: bool = True

    @classmethod
    def from_spec(cls, axis_names: Sequence[str], widths: Sequence[int],
                  pulses: Optional[Sequence[int]] = None,
                  **kw) -> "ScheduleConfig":
        """Derive ``n_pulses`` from a halo spec's pulse schedule.

        Routes the spec through :func:`check_halo_config` first, so
        nonsense ``(widths, pulses)`` combinations fail here with the
        same actionable message the build gate raises.
        """
        sched = check_halo_config(axis_names, widths, pulses)
        return cls(n_pulses=max(1, sched.total_pulses), **kw)

    @property
    def ring_depth(self) -> int:
        """Buffer slots actually in play (mode ``off`` has no ring)."""
        return self.depth if self.mode == "double_buffer" else 1

    def validate(self) -> None:
        if self.mode not in MODES:
            raise ConfigError(f"unknown pipeline mode {self.mode!r}; "
                              f"available: {MODES}")
        if self.depth < 1:
            raise ConfigError("depth must be >= 1")
        if self.mode == "double_buffer" and self.depth < 2:
            raise ConfigError("double_buffer needs depth >= 2 (ring "
                              "slots; 2 = double-buffered halos)")
        if self.n_steps < 1:
            raise ConfigError("n_steps must be >= 1")
        if self.window < 1:
            raise ConfigError("window (acquire skew) must be >= 1: skew 0 "
                              "would consume a deposit in the region that "
                              "produces it")
        if self.n_pulses < 1:
            raise ConfigError("n_pulses must be >= 1")
        if self.nstprune < 0:
            raise ConfigError("nstprune must be >= 0 (0 disables the "
                              "rolling inner prune)")


# --------------------------------------------------------------------------
# config checks shared with the build gates
# --------------------------------------------------------------------------

def check_halo_config(axis_names: Sequence[str], widths: Sequence[int],
                      pulses: Optional[Sequence[int]] = None):
    """Validate a halo spec's decomposition before any tracing.

    Returns the :class:`~repro_torch.core.schedule.PulseSchedule` on success.
    Raises :class:`ConfigError` (a ``ValueError``) with an actionable
    message otherwise — including the ``(widths, pulses)`` combinations
    ``make_schedule`` rejects, re-raised with their original wording so
    existing callers keep matching on it.
    """
    names = tuple(axis_names)
    dups = sorted({n for n in names if names.count(n) > 1})
    if dups:
        raise ConfigError(
            f"duplicate mesh axis names {dups} in halo spec {names}: each "
            "decomposition dim needs its own mesh axis, or pulses along "
            "distinct dims would alias one device ring")
    ws = tuple(int(w) for w in widths)
    if any(w < 0 for w in ws):
        raise ConfigError(
            f"halo widths must be >= 0, got {ws}: a negative width has no "
            "slab interpretation (use width 0 to disable a dim)")
    try:
        return make_schedule(names, ws, pulses)
    except ValueError as e:          # preserve make_schedule's wording
        raise ConfigError(str(e)) from e


def check_md_config(*, nstlist: int, nstprune: int, pipeline: str,
                    pipeline_depth: int, overlap_rebin: bool,
                    force_backend: str, inner_safety: float = 1.5,
                    r_list_factor: float = 1.08, mig_frac: float = 0.125,
                    capacity_safety: float = 2.2) -> ScheduleConfig:
    """Engine-level config check: the nonsense the tracer only hits late.

    Returns the :class:`ScheduleConfig` the engine's block programs will
    realize (so the caller can feed it straight to :func:`verify_build`).
    """
    if nstlist < 1:
        raise ConfigError(f"nstlist must be >= 1, got {nstlist}: the "
                          "block program needs at least one step between "
                          "pair-list rebuilds")
    if nstprune > nstlist:
        raise ConfigError(
            f"nstprune={nstprune} exceeds the nstlist block length "
            f"{nstlist}: the rolling inner prune would never fire inside "
            "a block — lower nstprune or raise params.nstlist")
    if nstprune and inner_safety <= 0:
        raise ConfigError(
            f"inner_safety must be > 0, got {inner_safety}: the inner "
            "tier ladder would have no capacity and every block would "
            "overflow to the outer ladder")
    if r_list_factor < 1.0:
        raise ConfigError(
            f"r_list_factor must be >= 1, got {r_list_factor}: a Verlet "
            "list radius below r_cut drops interacting pairs outright")
    if mig_frac <= 0:
        raise ConfigError(f"mig_frac must be > 0, got {mig_frac}: the "
                          "migration pool would hold zero atoms")
    if capacity_safety < 1.0:
        raise ConfigError(
            f"capacity_safety must be >= 1, got {capacity_safety}: cell "
            "slot capacity below the mean occupancy guarantees bin "
            "overflow at the first rebin")
    cfg = ScheduleConfig(mode=pipeline, depth=pipeline_depth,
                         n_steps=nstlist, nstprune=nstprune,
                         overlap_rebin=bool(overlap_rebin),
                         force_backend=force_backend)
    cfg.validate()
    return cfg


# --------------------------------------------------------------------------
# event extraction (mirrors the reference StepPipeline's serial and windowed
# schedules and the engine's block_sched sub-block unrolling)
# --------------------------------------------------------------------------

def _serial_events(n: int, step0: int) -> List[CommEvent]:
    ev = []
    for k in range(n):
        s = step0 + k
        ev.append(CommEvent(RELEASE, "fwd", 0, s, s, "serial"))
        ev.append(CommEvent(ACQUIRE, "fwd", 0, s, s, "serial"))
        ev.append(CommEvent(RELEASE, "rev", 0, s, s, "serial"))
        ev.append(CommEvent(ACQUIRE, "rev", 0, s, s, "serial"))
    return ev


def _pipelined_events(cfg: ScheduleConfig, n: int, step0: int
                      ) -> List[CommEvent]:
    d, w = cfg.depth, cfg.window
    span = d - 1
    n_full = (n - 1) // span if n > 1 else 0
    ev = []
    for k in range(n):
        s = step0 + k
        if k == 0:
            site = "prologue"
        elif k <= n_full * span:
            site = "window"
        else:
            site = "drain"
        if k >= w:
            dep = k - w
            ev.append(CommEvent(ACQUIRE, "rev", dep % d, s, step0 + dep,
                                site))
        ev.append(CommEvent(RELEASE, "fwd", k % d, s, s, site))
        ev.append(CommEvent(ACQUIRE, "fwd", k % d, s, s, site))
        ev.append(CommEvent(RELEASE, "rev", k % d, s, s, site))
    last = step0 + n - 1
    for k in range(max(0, n - w), n):
        ev.append(CommEvent(ACQUIRE, "rev", k % d, last, step0 + k,
                            "drain"))
    return ev


def _boundary_events(kinds: Sequence[str], step: int, site: str
                     ) -> List[CommEvent]:
    """Immediately-acquired exchanges outside ledger bookkeeping."""
    ev = []
    for kind in kinds:
        ev.append(CommEvent(RELEASE, kind, 0, step, step, site,
                            ledgered=False))
        ev.append(CommEvent(ACQUIRE, kind, 0, step, step, site,
                            ledgered=False))
    return ev


def extract_events(cfg: ScheduleConfig) -> Tuple[EventSegment, ...]:
    """The deterministic segment/event sequence one block would emit.

    Each segment corresponds to one fresh-ledger ``run_local`` chain
    (``StepPipeline`` re-inits its ledger per invocation, and the
    engine's rolling prune splits a block into one invocation per
    ``nstprune``-step sub-block).
    """
    run = (_serial_events if cfg.mode == "off" else
           functools.partial(_pipelined_events, cfg))
    segments: List[EventSegment] = []
    if cfg.nstprune:
        done = 0
        i = 0
        while done < cfg.n_steps:
            take = min(cfg.nstprune, cfg.n_steps - done)
            ev = _boundary_events(("fwd",), done, "prune")
            ev += run(take, done)
            segments.append(EventSegment(f"subblock[{i}](+{take})",
                                         tuple(ev)))
            done += take
            i += 1
    else:
        segments.append(EventSegment("block", tuple(run(cfg.n_steps, 0))))
    if cfg.overlap_rebin:
        ev = _boundary_events(("fwd", "rev"), cfg.n_steps, "rebin")
        if cfg.force_backend != "dense":
            ev += _boundary_events(("fwd", "fwd"), cfg.n_steps, "prune")
        segments.append(EventSegment("rebin", tuple(ev)))
    return tuple(segments)


# --------------------------------------------------------------------------
# replay + happens-before analysis
# --------------------------------------------------------------------------

def _trace(events: Sequence[CommEvent], idx: int, note: str,
           extra: Sequence[int] = ()) -> Tuple[str, ...]:
    """Counterexample window: the offending event in context."""
    mark = {idx, *extra}
    lo = max(0, min(mark) - 2)
    lines = []
    for i in range(lo, idx + 1):
        flag = ">>" if i in mark else "  "
        lines.append(f"{flag} [{i:3d}] {events[i].describe()}")
    lines.append(f"   ^ {note}")
    return tuple(lines)


def _replay_segment(seg: EventSegment) -> Tuple[List[Violation], dict,
                                                Dict[int, int]]:
    """Exhaustive slot-state enumeration over one segment's events.

    Walks the program order visiting every reachable
    ``(released, acquired)`` counter state per ``(kind, slot)`` signal;
    returns (violations, stats, acquire->release match map).
    """
    events = seg.events
    outstanding: Dict[Tuple[str, int], List[int]] = {}
    matches: Dict[int, int] = {}
    violations: List[Violation] = []
    in_flight = 0
    max_in_flight = 0
    releases = acquires = 0
    for i, ev in enumerate(events):
        key = (ev.kind, ev.slot)
        pending = outstanding.setdefault(key, [])
        if ev.op == RELEASE:
            releases += 1
            if pending:
                j = pending[0]
                violations.append(Violation(
                    "SLOT_CLOBBER", seg.label, i,
                    f"release {ev.kind} slot={ev.slot} @step {ev.step} "
                    f"lands on a still-outstanding deposit of step "
                    f"{events[j].deposit} (released @event {j}, never "
                    "acquired): the put clobbers an unconsumed buffer",
                    _trace(events, i,
                           f"clobbers the deposit released at [{j}]",
                           extra=[j])))
            pending.append(i)
            in_flight += 1
            max_in_flight = max(max_in_flight, in_flight)
        else:
            acquires += 1
            if not pending:
                violations.append(Violation(
                    "ACQUIRE_BEFORE_RELEASE", seg.label, i,
                    f"acquire {ev.kind} slot={ev.slot} @step {ev.step} "
                    "has no outstanding deposit to consume: the wait "
                    "would return before any put signalled",
                    _trace(events, i, "no matching release precedes "
                           "this acquire")))
            else:
                matches[i] = pending.pop(0)
                in_flight -= 1
    leftovers = [(k, js) for k, js in outstanding.items() if js]
    for (kind, slot), js in sorted(leftovers):
        i = js[-1]
        violations.append(Violation(
            "DRAIN_INCOMPLETE", seg.label, i,
            f"{len(js)} deposit(s) on {kind} slot={slot} still in flight "
            "at the end of the chain: the drain epilogue must leave zero "
            "outstanding signals",
            _trace(events, len(events) - 1,
                   f"deposit(s) released at {js} never acquired",
                   extra=js)))
    stats = {"releases": releases, "acquires": acquires,
             "max_in_flight": max_in_flight}
    return violations, stats, matches


def _hb_check(seg: EventSegment, matches: Dict[int, int],
              step_barrier: bool) -> List[Violation]:
    """Happens-before DAG: every slot reuse ordered after the drain.

    Nodes are the segment's events; edges are (a) per-step dataflow
    chains (events executing in one step's program region), (b) the
    step-boundary ``optimization_barrier`` pin, (c) release->acquire
    signal edges.  For each consecutive pair of releases on one
    ``(kind, slot)``, the earlier deposit's acquire must be an ancestor
    of the later release — otherwise the reuse is only safe under one
    particular linearization and a legal async reordering clobbers it.
    """
    events = seg.events
    n = len(events)
    preds: List[List[int]] = [[] for _ in range(n)]
    last_of_step: Dict[int, int] = {}
    first_of_step: Dict[int, int] = {}
    prev_same_step: Dict[int, int] = {}
    for i, ev in enumerate(events):
        if ev.step in prev_same_step:
            preds[i].append(prev_same_step[ev.step])
        prev_same_step[ev.step] = i
        first_of_step.setdefault(ev.step, i)
        last_of_step[ev.step] = i
    if step_barrier:
        steps = sorted(first_of_step)
        for a, b in zip(steps, steps[1:]):
            preds[first_of_step[b]].append(last_of_step[a])
    for acq, rel in matches.items():
        preds[acq].append(rel)
    # ancestor bitsets in index (= topological) order
    anc = [0] * n
    for i in range(n):
        bits = 0
        for p in preds[i]:
            bits |= anc[p] | (1 << p)
        anc[i] = bits
    acquired_at = {rel: acq for acq, rel in matches.items()}
    by_slot: Dict[Tuple[str, int], List[int]] = {}
    for i, ev in enumerate(events):
        if ev.op == RELEASE:
            by_slot.setdefault((ev.kind, ev.slot), []).append(i)
    violations = []
    for (kind, slot), rels in sorted(by_slot.items()):
        for r1, r2 in zip(rels, rels[1:]):
            a1 = acquired_at.get(r1)
            if a1 is None:
                continue          # replay already reported the clobber
            if not (anc[r2] >> a1) & 1:
                violations.append(Violation(
                    "UNORDERED_REUSE", seg.label, r2,
                    f"release {kind} slot={slot} @step {events[r2].step} "
                    f"is not ordered after the acquire of the previous "
                    f"deposit (step {events[r1].deposit}): no "
                    "happens-before path pins the reuse behind the "
                    "drain, so an async reordering may clobber it",
                    _trace(events, r2, f"no path from the acquire at "
                           f"[{a1}] to this reuse", extra=[r1, a1])))
    return violations


# --------------------------------------------------------------------------
# reports + entry points
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ScheduleReport:
    """Structured verdict of one configuration's static replay."""

    config: ScheduleConfig
    safe: bool
    violations: Tuple[Violation, ...]
    stats: Dict[str, int] = field(default_factory=dict)
    segments: Tuple[EventSegment, ...] = ()

    def counterexample(self) -> str:
        """Formatted event trace of the first violation ('' when safe)."""
        if self.safe:
            return ""
        v = self.violations[0]
        head = (f"{v.code} in segment {v.segment!r} "
                f"(event {v.index}): {v.message}")
        return "\n".join([head, *v.trace])

    def summary(self) -> str:
        c = self.config
        verdict = "SAFE" if self.safe else \
            f"UNSAFE ({len(self.violations)} violation(s))"
        return (f"{verdict}: mode={c.mode} depth={c.depth} "
                f"window={c.window} n_steps={c.n_steps} "
                f"n_pulses={c.n_pulses} nstprune={c.nstprune} "
                f"overlap_rebin={c.overlap_rebin} backend={c.backend} "
                f"[{self.stats.get('n_events', 0)} events / "
                f"{self.stats.get('n_segments', 0)} segment(s), "
                f"max in-flight {self.stats.get('max_in_flight', 0)}]")

    def to_dict(self) -> dict:
        """JSON-able form (the CLI's ``--report`` payload)."""
        return {
            "config": {k: getattr(self.config, k) for k in (
                "mode", "depth", "n_steps", "window", "n_pulses",
                "nstprune", "overlap_rebin", "backend", "force_backend",
                "step_barrier")},
            "safe": self.safe,
            "stats": dict(self.stats),
            "violations": [
                {"code": v.code, "segment": v.segment, "index": v.index,
                 "message": v.message, "trace": list(v.trace)}
                for v in self.violations],
        }


def verify_schedule(cfg: ScheduleConfig) -> ScheduleReport:
    """Statically verify one configuration's comm schedule.

    Raises :class:`ConfigError` for configurations with no schedule
    interpretation; otherwise always returns a report (``safe=False``
    reports carry counterexample traces).
    """
    cfg.validate()
    segments = extract_events(cfg)
    violations: List[Violation] = []
    stats = {"n_segments": len(segments), "n_events": 0, "releases": 0,
             "acquires": 0, "max_in_flight": 0}
    for seg in segments:
        vs, st, matches = _replay_segment(seg)
        violations += vs
        violations += _hb_check(seg, matches, cfg.step_barrier)
        stats["n_events"] += len(seg.events)
        stats["releases"] += st["releases"]
        stats["acquires"] += st["acquires"]
        stats["max_in_flight"] = max(stats["max_in_flight"],
                                     st["max_in_flight"])
    order = {"ACQUIRE_BEFORE_RELEASE": 0, "SLOT_CLOBBER": 1,
             "UNORDERED_REUSE": 2, "DRAIN_INCOMPLETE": 3}
    violations.sort(key=lambda v: (v.segment, v.index, order[v.code]))
    return ScheduleReport(config=cfg, safe=not violations,
                          violations=tuple(violations), stats=stats,
                          segments=segments)


def probe_steps(depth: int, nstprune: int = 0,
                n_steps: Optional[int] = None) -> Tuple[int, ...]:
    """Block lengths that exhaust the ring's reachable phase space.

    The depth-``d`` ring is periodic in ``d``: slot occupancy at step
    ``k`` depends only on ``k mod d`` and on how far the drain tail
    reaches back, so every distinct (ring phase, drain point) pair is
    realized by some ``n_steps <= 2 d + 3``.  ``nstprune`` adds the
    sub-block split points; an explicit ``n_steps`` (the engine's
    nstlist) is always probed as well.
    """
    probes = set(range(1, 2 * max(depth, 1) + 4))
    if nstprune:
        probes.update({nstprune, nstprune + 1, 2 * nstprune + 1})
    if n_steps:
        probes.add(int(n_steps))
    return tuple(sorted(probes))


@functools.lru_cache(maxsize=None)
def verify_build(*, mode: str, depth: int, n_pulses: int = 1,
                 window: int = 1, nstprune: int = 0,
                 overlap_rebin: bool = False, backend: str = "fused",
                 force_backend: str = "dense",
                 n_steps: Optional[int] = None) -> ScheduleReport:
    """Verify a build-time configuration over the exhaustive probe set.

    Replays every block length in :func:`probe_steps` and returns the
    first unsafe report found, else the largest probe's (safe) report.
    Cached: repeated builds of one configuration (every ``MDEngine``
    probes its pipeline) cost one dict lookup.
    """
    report = None
    for n in probe_steps(depth, nstprune=nstprune, n_steps=n_steps):
        report = verify_schedule(ScheduleConfig(
            mode=mode, depth=depth, n_steps=n, window=window,
            n_pulses=n_pulses, nstprune=nstprune,
            overlap_rebin=overlap_rebin, backend=backend,
            force_backend=force_backend))
        if not report.safe:
            return report
    return report


def gate_schedule(report: ScheduleReport, verify: str = "error",
                  where: str = "StepPipeline.build"
                  ) -> Optional[ScheduleReport]:
    """Promote a report to a build-time verdict.

    ``verify="error"`` raises :class:`ScheduleVerificationError` with the
    counterexample trace embedded; ``"warn"`` downgrades to a
    ``RuntimeWarning`` (the experimentation escape hatch); ``"off"`` is
    handled by callers (no report is produced at all).
    """
    if verify not in VERIFY_MODES:
        raise ValueError(f"unknown verify mode {verify!r}; "
                         f"available: {VERIFY_MODES}")
    if report.safe:
        return report
    msg = (f"{where}: statically unsafe comm schedule — "
           f"{report.summary()}\n{report.counterexample()}")
    if verify == "warn":
        warnings.warn(msg, RuntimeWarning, stacklevel=3)
        return report
    raise ScheduleVerificationError(msg, report)


def gate_pipeline_build(*, mode: str, depth: int, n_pulses: int,
                        backend: str, verify: str = "error",
                        window: int = 1) -> Optional[ScheduleReport]:
    """The gate ``StepPipeline.build`` runs before accepting a config."""
    if verify not in VERIFY_MODES:
        raise ValueError(f"unknown verify mode {verify!r}; "
                         f"available: {VERIFY_MODES}")
    if verify == "off":
        return None
    try:
        report = verify_build(mode=mode, depth=depth, n_pulses=n_pulses,
                              backend=backend, window=window)
    except ConfigError:
        if verify == "warn":
            warnings.warn("StepPipeline.build: config rejected by the "
                          "static verifier (verify='warn' keeps going)",
                          RuntimeWarning, stacklevel=3)
            return None
        raise
    return gate_schedule(report, verify, where="StepPipeline.build")


def gate_md_build(*, nstlist: int, nstprune: int, pipeline: str,
                  pipeline_depth: int, overlap_rebin: bool,
                  force_backend: str, n_pulses: int = 1,
                  verify: str = "error", **check_kw
                  ) -> Optional[ScheduleReport]:
    """The gate ``MDEngine.__init__`` runs before building programs."""
    if verify not in VERIFY_MODES:
        raise ValueError(f"unknown verify mode {verify!r}; "
                         f"available: {VERIFY_MODES}")
    if verify == "off":
        return None
    try:
        cfg = check_md_config(nstlist=nstlist, nstprune=nstprune,
                              pipeline=pipeline,
                              pipeline_depth=pipeline_depth,
                              overlap_rebin=overlap_rebin,
                              force_backend=force_backend, **check_kw)
        report = verify_build(
            mode=cfg.mode, depth=cfg.depth, n_pulses=n_pulses,
            nstprune=cfg.nstprune, overlap_rebin=cfg.overlap_rebin,
            force_backend=cfg.force_backend, n_steps=cfg.n_steps)
    except ConfigError as e:
        if verify == "warn":
            warnings.warn(f"MDEngine: config rejected by the static "
                          f"verifier (verify='warn' keeps going): {e}",
                          RuntimeWarning, stacklevel=3)
            return None
        raise
    return gate_schedule(report, verify, where="MDEngine")
