"""StepPipeline: the multi-step program over one halo plan.

The port of the JAX package's ``core/pipeline/step_pipeline.py`` in its
``pipeline="off"`` mode: the strictly serialized reference chain, each
step ``begin -> fwd halo -> forces -> rev halo -> finish``.  The reference
runs it as a ``lax.scan``; here it is a Python loop over steps on the
device, with per-step metrics kept on the device and stacked at the end
(no host round trip inside a block).

The ``"double_buffer"`` mode, its signal ledger, wire rings and fault
injection come with a later slice of the port; asking for them raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core.halo_plan import HaloPlan

PIPELINE_MODES = ("off", "double_buffer")
Metrics = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class StepFns:
    """The engine-supplied physics of one step, split at the halo seams.

    ``begin(state, f, ctx) -> (state, aux, payload)``, ``force(ext, ctx)
    -> (F_ext, metrics)``, ``finish(state, aux, f, ctx) -> (state,
    f_carry, metrics)``.  Metric keys are unique across ``force`` and
    ``finish``; ``ctx`` is constant for the whole multi-step call.
    """

    begin: Callable[[Any, torch.Tensor, Any], Tuple[Any, Any, torch.Tensor]]
    force: Callable[[torch.Tensor, Any], Tuple[torch.Tensor, Metrics]]
    finish: Callable[[Any, Any, torch.Tensor, Any],
                     Tuple[Any, torch.Tensor, Metrics]]


class StepPipeline:
    """Construct-once multi-step program over one :class:`HaloPlan`."""

    def __init__(self, plan: HaloPlan, fns: StepFns, mode: str = "off"):
        if mode not in PIPELINE_MODES:
            raise ValueError(f"unknown pipeline mode {mode!r}; "
                             f"available: {PIPELINE_MODES}")
        if mode != "off":
            raise NotImplementedError(
                f"pipeline mode {mode!r} is not ported yet: the "
                "double-buffered pipeline comes with the step-pipeline and "
                "signal-backend slice of the port")
        self.plan = plan
        self.fns = fns
        self.mode = mode

    @classmethod
    def build(cls, plan: HaloPlan, fns: StepFns, *,
              mode: str = "off") -> "StepPipeline":
        return cls(plan, fns, mode=mode)

    def run_local(self, state, f0: torch.Tensor, n_steps: int, ctx=None
                  ) -> Tuple[Any, torch.Tensor, Metrics]:
        """Run ``n_steps`` steps; returns the final state, the last step's
        returned forces and the per-step metrics stacked on dim 0."""
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        return self._run_serial(state, f0, n_steps, ctx)

    def _run_serial(self, state, f0, n_steps, ctx):
        fns, plan = self.fns, self.plan
        f = f0
        per_step = []
        for _ in range(n_steps):
            state, aux, payload = fns.begin(state, f, ctx)
            ext = plan.fwd_local(payload)
            F_ext, m_force = fns.force(ext, ctx)
            f_new = plan.rev_local(F_ext)
            state, f, m_fin = fns.finish(state, aux, f_new, ctx)
            per_step.append({**m_force, **m_fin})
        metrics = {k: torch.stack([m[k] for m in per_step])
                   for k in per_step[0]}
        return state, f, metrics

    def __repr__(self):
        return f"StepPipeline(mode={self.mode!r}, plan={self.plan!r})"
