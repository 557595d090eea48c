"""StepPipeline: construct-once, depth-buffered multi-step programs.

The port of the JAX package's ``core/pipeline/step_pipeline.py``, the
seam between a :class:`~repro_torch.core.halo_plan.HaloPlan` and an
engine's physics:

* ``pipeline="off"``: the strictly serialized reference chain, each step
  ``begin -> fwd halo -> forces -> rev halo -> finish``.
* ``pipeline="double_buffer"``: the ledger of the software-pipelined
  schedule with a ``depth >= 2`` in-flight window.  Step ``k``'s signals
  live on slot ``k % depth`` of a
  :class:`~repro_torch.core.pipeline.ledger.SignalLedger`; the build-time
  verifier replays this mode's windowed release/acquire schedule.

The reference runs both as ``lax.scan`` programs and lets XLA overlap a
window's force returns with the next steps' work.  Here both modes are
one Python loop issuing every step's work on one CUDA stream, with
per-step metrics kept on the device and stacked at the end (no host read
inside a block).  Unrolled, the reference's windowed order (prologue,
windows of ``depth - 1`` steps, epilogue drain) issues each step's
``begin -> fwd -> force -> rev -> finish`` and each slot's release /
acquire events in the serial order, so on one stream it is the serial
chain: ``double_buffer`` differs from ``off`` only in the ledger slot a
step's signals use, and both give bitwise identical trajectories at
every depth.  Real overlap (a second stream, or a CUDA graph per block)
is later work.

With a wire format (``HaloSpec.wire_dtype``) the force return carries
the named format, quantized at the plan seam in both modes
(``plan.rev_local``, or ``plan.rev_local_ef`` threading the ``int8_ef``
error-feedback residual step by step).  The reference's
``double_buffer`` keeps its in-flight slot ring in wire form
(``plan.wire_encode_ext`` at fill, ``plan.wire_decode_ext`` and
``plan.rev_local_raw`` at drain); that pair equals the seam bitwise, and
with no window in flight here there is nothing for it to hold, so one
path serves both modes until a real ring exists.  The coordinate
direction's float32 floor sits inside ``plan.fwd_local``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.analysis.schedule_verifier import gate_pipeline_build
from repro_torch.core.halo_plan import HaloPlan
from repro_torch.core.pipeline.ledger import LedgerState, SignalLedger

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
    """

    begin: Callable[[Any, torch.Tensor, Any], Tuple[Any, Any, torch.Tensor]]
    force: Callable[[torch.Tensor, Any], Tuple[torch.Tensor, Metrics]]
    finish: Callable[[Any, Any, torch.Tensor, Any],
                     Tuple[Any, torch.Tensor, Metrics]]


def _stack(per_step: List[Metrics]) -> Metrics:
    return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}


class StepPipeline:
    """Construct-once multi-step program over one :class:`HaloPlan`."""

    def __init__(self, plan: HaloPlan, fns: StepFns,
                 mode: str = "double_buffer", depth: int = 2,
                 verify: str = "error"):
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

    @classmethod
    def build(cls, plan: HaloPlan, fns: StepFns, *,
              mode: str = "double_buffer", depth: int = 2,
              verify: str = "error") -> "StepPipeline":
        return cls(plan, fns, mode=mode, depth=depth, verify=verify)

    # -- execution -----------------------------------------------------------

    def _rev(self, F_ext: torch.Tensor, wire_on: bool, wef):
        """One step's force return: ``(f, new_ef)``.  ``wire_on`` is the
        reference's ``_wire_state``: a wire format and a floating
        payload; ``wef`` the ``int8_ef`` residual (None until the first
        step sizes it)."""
        plan = self.plan
        if not (wire_on and plan.wire.stateful):
            return plan.rev_local(F_ext), wef
        if wef is None:
            wef = torch.zeros_like(F_ext)
        return plan.rev_local_ef(F_ext, wef)

    def run_local(self, state, f0: torch.Tensor, n_steps: int, ctx=None
                  ) -> Tuple[Any, torch.Tensor, Metrics, LedgerState]:
        """Run ``n_steps`` steps; returns the final state, the last step's
        returned forces, the per-step metrics stacked on dim 0 and the
        final signal-ledger state."""
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        fns, plan, ledger = self.fns, self.plan, self.ledger
        led, f, per_step = ledger.init(), f0, []
        wire_on, wef = False, None
        for k in range(n_steps):
            buf = k % self.depth
            state, aux, payload = fns.begin(state, f, ctx)
            if k == 0:
                wire_on = plan._wire_active(payload)
            led = ledger.release(led, "fwd", buf)
            ext = plan.fwd_local(payload)
            led = ledger.acquire(led, "fwd", buf)
            F_ext, m_force = fns.force(ext, ctx)
            led = ledger.release(led, "rev", buf)
            f_new, wef = self._rev(F_ext, wire_on, wef)
            led = ledger.acquire(led, "rev", buf)
            state, f, m_fin = fns.finish(state, aux, f_new, ctx)
            per_step.append({**m_force, **m_fin})
        return state, f, _stack(per_step), led

    # -- introspection -----------------------------------------------------

    def stats(self, local_shape, **kw) -> dict:
        """Plan stats at this pipeline mode / depth (overlap + latency)."""
        kw.setdefault("depth", max(self.depth, 2))
        return self.plan.stats(local_shape, pipeline=self.mode, **kw)

    def __repr__(self):
        return (f"StepPipeline(mode={self.mode!r}, depth={self.depth}, "
                f"plan={self.plan!r})")
