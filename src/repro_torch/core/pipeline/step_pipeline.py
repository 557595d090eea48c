"""StepPipeline: construct-once, depth-buffered multi-step programs.

The port of the JAX package's ``core/pipeline/step_pipeline.py``, the
seam between a :class:`~repro_torch.core.halo_plan.HaloPlan` and an
engine's physics:

* ``pipeline="off"``: the strictly serialized reference chain, each step
  ``begin -> fwd halo -> forces -> rev halo -> finish`` (``_run_serial``).
* ``pipeline="double_buffer"``: the reference's software-pipelined
  schedule with a ``depth >= 2`` in-flight window (``_run_pipelined``).
  Extended force buffers live in a ``depth``-slot ring: the prologue runs
  step 0's forward half and fills slot 0; each later step's skew-one unit
  drains slot ``(k - 1) % depth`` (force return, final kick), then runs
  its own ``begin``, forward halo and forces and fills slot ``k % depth``,
  its force-return signal released at fill and acquired one step later;
  the reference's windows of ``depth - 1`` units and its remainder run
  back to back on one stream, then the epilogue drains the last slot.
  Step ``k``'s signals live on slot ``k % depth`` of a
  :class:`~repro_torch.core.pipeline.ledger.SignalLedger`, in the
  reference's order, and its halo launches use that slot's signal words
  (``plan.fwd_local(..., slot=)``); the build-time verifier replays this
  schedule.

Both modes run the same per-step operations on the same data in the same
order (velocity Verlet needs step ``k``'s returned forces before step
``k + 1``'s kick-drift), so they give bitwise identical trajectories at
every depth.  Per-step metrics stay on the device and are stacked at the
end, re-aligned as the reference's (a unit emits step ``k``'s force
metrics beside step ``k - 1``'s finish metrics).

Each step's device work is one function of tensors (the serial step; the
prologue, the unit of each ring slot, the epilogue of each slot), issued
eagerly or, given ``graphs`` (:mod:`repro_torch.core.pipeline.block_graph`),
as a CUDA graph per function and input shape; the ledger's transitions
are host bookkeeping and run around it.

With a wire format (``HaloSpec.wire_dtype``) the force return carries
the named format.  ``off`` quantizes at the plan seam (``plan.rev_local``,
or ``plan.rev_local_ef`` threading the ``int8_ef`` residual); the ring
holds each slot in wire form (``plan.wire_encode_ext`` at fill, the
residual updated there, once per step as in serial mode) and drains it
through ``plan.wire_decode_ext`` and ``plan.rev_local_raw``; the two
compositions are equal bitwise.  The coordinate direction's float32
floor sits inside ``plan.fwd_local``.

Fault injection (``inject=True``, :mod:`repro_torch.resilience`): the
reference's seams, per step ``k`` of a block-relative fault vector (the
``ledger.SCAN_FAULT_SITES`` layout).  The host decides which sites fire at
``k`` and passes the armed device sites (``halo_corrupt``: NaN the
received slab of the last decomposed dim; ``force_nan``: NaN the force
output) to the step unit as a tuple among its inputs, so a disarmed step
issues exactly an ``inject=False`` step's operations (its graph has the
same key part, ``()``, and nodes) and an armed one is a key of its own.
``signal_drop`` is host bookkeeping only: the ledger skips the step's
force-return release (:meth:`SignalLedger.release_dropped`) and the
kernels run unchanged.  An enabled tracer adds the reference's per-step
``obs/*`` ledger counters to the metrics, host values read from the
ledger after each step's transitions (CPU tensors: nothing reaches the
device).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.schedule_verifier import gate_pipeline_build
from repro_torch.core.halo_plan import HaloPlan
from repro_torch.core.pipeline.ledger import (
    FAULT_DROP,
    FAULT_FORCE,
    FAULT_HALO,
    LedgerState,
    SignalLedger,
)
from repro_torch.obs.tracing import NULL_TRACER, PhaseTracer

PIPELINE_MODES = ("off", "double_buffer")
Metrics = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class StepFns:
    """The engine-supplied physics of one step, split at the halo seams.

    ``begin(state, f, ctx) -> (state, aux, payload)``, ``force(ext, ctx)
    -> (F_ext, metrics)``, ``finish(state, aux, f, ctx) -> (state,
    f_carry, metrics)``.  Metric keys are unique across ``force`` and
    ``finish``; ``ctx`` is constant for the whole multi-step call, so both
    pipeline modes see the same block-level inputs.  ``force`` must return
    a fresh tensor (the ring keeps it until its slot drains).

    ``reduce``, when given, maps the raw tensors that ``force`` and
    ``finish`` return as metrics (either dict alone) to the step's
    metrics.  None: the metrics are final as returned.
    """

    begin: Callable[[Any, torch.Tensor, Any], Tuple[Any, Any, torch.Tensor]]
    force: Callable[[torch.Tensor, Any], Tuple[torch.Tensor, Metrics]]
    finish: Callable[[Any, Any, torch.Tensor, Any],
                     Tuple[Any, torch.Tensor, Metrics]]
    reduce: Optional[Callable[[Metrics], Metrics]] = None


def _stack(per_step: List[Metrics]) -> Metrics:
    return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}


def _host_stack(per_step: List[dict]) -> Metrics:
    """Per-step host values (the tracer's counters) as CPU int32 tensors
    with the step on dim 0."""
    if not per_step or not per_step[0]:
        return {}
    return {k: torch.from_numpy(np.array([m[k] for m in per_step],
                                         np.int32)) for k in per_step[0]}


class StepPipeline:
    """Construct-once multi-step program over one :class:`HaloPlan`.

    ``graphs`` (a :class:`~repro_torch.core.pipeline.block_graph.BlockGraphs`)
    issues each step's device work as a CUDA graph, keyed by ``graph_key``
    and the step's function; None issues it eagerly.  ``tracer`` (a
    :class:`~repro_torch.obs.tracing.PhaseTracer`) and ``inject`` are the
    reference's."""

    def __init__(self, plan: HaloPlan, fns: StepFns,
                 mode: str = "double_buffer", depth: int = 2,
                 verify: str = "error", graphs=None, graph_key=(),
                 tracer: PhaseTracer = None, inject: bool = False):
        if mode not in PIPELINE_MODES:
            raise ValueError(f"unknown pipeline mode {mode!r}; "
                             f"available: {PIPELINE_MODES}")
        if depth < 2 and mode == "double_buffer":
            raise ValueError("double_buffer needs depth >= 2")
        self.plan = plan
        self.fns = fns
        self.mode = mode
        self.depth = int(depth) if mode == "double_buffer" else 1
        self.ledger = SignalLedger(depth=self.depth,
                                   n_pulses=max(1, plan.sched.total_pulses))
        # build-time gate: statically replay the release/acquire schedule
        # this (mode, depth, pulses) config emits and reject it with a
        # counterexample event trace if any slot state is unsafe;
        # ``verify="warn"`` downgrades to a warning, ``"off"`` skips
        self.schedule_report = gate_pipeline_build(
            mode=self.mode, depth=self.depth,
            n_pulses=self.ledger.n_pulses, backend=plan.spec.backend,
            verify=verify)
        self.graphs = graphs
        self.graph_key = tuple(graph_key)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.inject = bool(inject)

    @classmethod
    def build(cls, plan: HaloPlan, fns: StepFns, *,
              mode: str = "double_buffer", depth: int = 2,
              verify: str = "error", graphs=None, graph_key=(),
              tracer: PhaseTracer = None,
              inject: bool = False) -> "StepPipeline":
        return cls(plan, fns, mode=mode, depth=depth, verify=verify,
                   graphs=graphs, graph_key=graph_key, tracer=tracer,
                   inject=inject)

    # -- execution -----------------------------------------------------------

    def run_local(self, state, f0: torch.Tensor, n_steps: int, ctx=None,
                  fault_vec=None
                  ) -> Tuple[Any, torch.Tensor, Metrics, LedgerState]:
        """Run ``n_steps`` steps; returns the final state, the last step's
        returned forces, the per-step metrics stacked on dim 0 and the
        final signal-ledger state.

        ``fault_vec`` (an ``inject=True`` pipeline's, and required there,
        as the reference's ``ctx["fault_vec"]``): one step index per site
        of ``ledger.SCAN_FAULT_SITES``, relative to this call, ``-1``
        disarmed."""
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        if self.inject and fault_vec is None:
            raise KeyError("fault_vec: an inject=True pipeline runs with "
                           "a fault vector (ledger.SCAN_FAULT_SITES "
                           "layout, -1 disarmed)")
        fv = tuple(int(v) for v in fault_vec) if self.inject else None
        if self.mode == "off":
            return self._run_serial(state, f0, n_steps, ctx, fv)
        return self._run_pipelined(state, f0, n_steps, ctx, fv)

    # -- fault injection (host-decided per step) -------------------------------

    @staticmethod
    def _fire(fv, k: int) -> tuple:
        """The device sites of fault vector ``fv`` that fire at step
        ``k`` (``()`` when disarmed: the step's graph key is then an
        ``inject=False`` step's)."""
        if fv is None:
            return ()
        return tuple(s for s in (FAULT_HALO, FAULT_FORCE) if fv[s] == k)

    def _release_rev(self, led, buf: int, fv, k: int):
        """The force-return release, droppable under injection."""
        if fv is None:
            return self.ledger.release(led, "rev", buf)
        return self.ledger.release_dropped(led, "rev", buf,
                                           fv[FAULT_DROP] == k)

    def _poison_halo(self, ext, payload):
        """NaN the *received* halo slab: the trailing cells of the last
        decomposed dim, everything the exchange appended beyond the local
        payload there (the reference's slab, its dims after the lane and
        domain dims)."""
        ax = self.plan.n_lead + len(self.plan.spec.axis_names) - 1
        idx = (slice(None),) * ax + (slice(payload.shape[ax], None),)
        ext = ext.clone()
        ext[idx] = float("nan")
        return ext

    @staticmethod
    def _poison_force(F_ext):
        """NaN the force output's whole slab."""
        return torch.full_like(F_ext, float("nan"))

    def _issue(self, kind: str, fn, inputs: tuple, ctx):
        """``fn(*inputs, ctx)``: eagerly, or through :attr:`graphs` (the
        step context a constant of the graph; a ring slot, an int among
        the inputs, part of the graph's key)."""
        if self.graphs is None:
            return fn(*inputs, ctx)
        return self.graphs.run(kind, self.graph_key, fn, inputs, (ctx,))

    def _metrics(self, raw: Metrics) -> Metrics:
        return raw if self.fns.reduce is None else self.fns.reduce(raw)

    def _serial_step(self, fire, state, f, wef, ctx):
        """One step of the serial chain, ``fire`` its armed device fault
        sites: ``(state, f, wef, metrics)``."""
        fns, plan = self.fns, self.plan
        state, aux, payload = fns.begin(state, f, ctx)
        ext = plan.fwd_local(payload, slot=0)
        if FAULT_HALO in fire:
            ext = self._poison_halo(ext, payload)
        F_ext, m_force = fns.force(ext, ctx)
        if FAULT_FORCE in fire:
            F_ext = self._poison_force(F_ext)
        if plan._wire_active(payload) and plan.wire.stateful:
            if wef is None:
                wef = torch.zeros_like(F_ext)
            f_new, wef = plan.rev_local_ef(F_ext, wef, slot=0)
        else:
            f_new = plan.rev_local(F_ext, slot=0)
        state, f, m_fin = fns.finish(state, aux, f_new, ctx)
        return state, f, wef, self._metrics({**m_force, **m_fin})

    def _run_serial(self, state, f, n_steps, ctx, fv=None):
        ledger, tracer = self.ledger, self.tracer
        led, per_step, obs, wef = ledger.init(), [], [], None
        for k in range(n_steps):
            led = ledger.release(led, "fwd", 0)
            led = ledger.acquire(led, "fwd", 0)
            led = self._release_rev(led, 0, fv, k)
            led = ledger.acquire(led, "rev", 0)
            obs.append(tracer.step_metrics(ledger, led))
            state, f, wef, m = self._issue(
                "step", self._serial_step,
                (self._fire(fv, k), state, f, wef), ctx)
            per_step.append(m)
        return state, f, {**_stack(per_step), **_host_stack(obs)}, led

    # -- the depth-d ring ------------------------------------------------------

    def _fill(self, F_ext, wef, wire_on: bool):
        """A step's extended forces as a ring slot holds them: as they
        are, or under a wire format as ``wire_encode_ext``'s parts (the
        int8_ef residual updates here).  Returns ``(held, wef)``."""
        if not wire_on:
            return F_ext, wef
        if wef is None and self.plan.wire.stateful:
            wef = torch.zeros_like(F_ext)
        return self.plan.wire_encode_ext(F_ext, wef)

    def _drain(self, held, slot: int):
        """Ring slot ``slot``'s force return from ``held`` as
        :meth:`_fill` left it: decoded and spliced under a wire format
        (the parts are a tuple; the exact body, last, has the forces'
        dtype)."""
        if not isinstance(held, tuple):
            return self.plan.rev_local(held, slot=slot)
        return self.plan.rev_local_raw(
            self.plan.wire_decode_ext(held, held[-1].dtype), slot=slot)

    def _forward_half(self, fire, state, f, wef, cur: int, ctx):
        """A step's ``begin``, forward halo and forces (``fire`` its armed
        device fault sites), filling ring slot ``cur``: ``(state, aux,
        held, wef, force metrics)``."""
        fns, plan = self.fns, self.plan
        state, aux, payload = fns.begin(state, f, ctx)
        ext = plan.fwd_local(payload, slot=cur)
        if FAULT_HALO in fire:
            ext = self._poison_halo(ext, payload)
        F_ext, m_force = fns.force(ext, ctx)
        if FAULT_FORCE in fire:
            F_ext = self._poison_force(F_ext)
        held, wef = self._fill(F_ext, wef, plan._wire_active(payload))
        return state, aux, held, wef, self._metrics(m_force)

    def _prologue(self, fire, state, f0, ctx):
        """Step 0's forward half into slot 0."""
        return self._forward_half(fire, state, f0, None, 0, ctx)

    def _unit(self, cur: int, fire, state, aux, held, wef, ctx):
        """The skew-one unit of a step ``k`` with ``k % depth == cur``
        (``held``: slot ``(k - 1) % depth``): drain step ``k - 1``'s force
        return and finish it, then run step ``k``'s forward half into slot
        ``cur``: ``(state, aux, held, wef, finish metrics, force
        metrics)``."""
        f_prev = self._drain(held, (cur - 1) % self.depth)
        state, f_carry, m_fin = self.fns.finish(state, aux, f_prev, ctx)
        state, aux, held, wef, m_force = self._forward_half(
            fire, state, f_carry, wef, cur, ctx)
        return state, aux, held, wef, self._metrics(m_fin), m_force

    def _epilogue(self, slot: int, state, aux, held, ctx):
        """Drain slot ``slot`` and finish the last step."""
        f_last = self._drain(held, slot)
        state, f_carry, m_fin = self.fns.finish(state, aux, f_last, ctx)
        return state, f_carry, self._metrics(m_fin)

    def _run_pipelined(self, state, f0, n_steps, ctx, fv=None):
        ledger, depth, tracer = self.ledger, self.depth, self.tracer
        # prologue: step 0's forward half fills slot 0; its force-return
        # signal is released at once
        led = ledger.release(ledger.init(), "fwd", 0)
        led = ledger.acquire(led, "fwd", 0)
        led = self._release_rev(led, 0, fv, 0)
        state, aux, held, wef, m_force = self._issue(
            "prologue", self._prologue, (self._fire(fv, 0), state, f0), ctx)
        forces, fins, obs = [m_force], [], []
        # the reference's windows of depth - 1 units, then its remainder:
        # on one stream, the units of steps 1 .. n - 1 back to back
        for k in range(1, n_steps):
            prev, cur = (k - 1) % depth, k % depth
            led = ledger.acquire(led, "rev", prev)
            led = ledger.release(led, "fwd", cur)
            led = ledger.acquire(led, "fwd", cur)
            led = self._release_rev(led, cur, fv, k)
            # beside step k - 1's finish metrics, as the reference's unit
            obs.append(tracer.step_metrics(ledger, led))
            state, aux, held, wef, m_fin, m_force = self._issue(
                f"unit{cur}", self._unit,
                (cur, self._fire(fv, k), state, aux, held, wef), ctx)
            fins.append(m_fin)
            forces.append(m_force)
        # epilogue: the last step's outstanding force return
        last = (n_steps - 1) % depth
        led = ledger.acquire(led, "rev", last)
        obs.append(tracer.step_metrics(ledger, led))
        state, f_carry, m_fin = self._issue(
            f"epilogue{last}", self._epilogue, (last, state, aux, held), ctx)
        fins.append(m_fin)
        # re-align: the prologue and units emitted step k's force metrics
        # beside step k - 1's finish metrics
        return state, f_carry, {**_stack(forces), **_stack(fins),
                                **_host_stack(obs)}, led

    # -- introspection -----------------------------------------------------

    def stats(self, local_shape, **kw) -> dict:
        """Plan stats at this pipeline mode / depth (overlap + latency)."""
        kw.setdefault("depth", max(self.depth, 2))
        return self.plan.stats(local_shape, pipeline=self.mode, **kw)

    def __repr__(self):
        return (f"StepPipeline(mode={self.mode!r}, depth={self.depth}, "
                f"plan={self.plan!r})")
