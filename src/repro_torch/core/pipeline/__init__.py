"""Multi-step overlap subsystem: the layer between a halo plan and the
MD engine's step programs.

* :class:`SignalLedger`: the put-with-signal bookkeeping model
  (release / acquire / clobber counters per buffer slot and pulse);
* the ``"signal"`` halo backend: fused pack + put-with-signal pulses
  through ``put_signal`` / ``fused_pulses`` (registered into the
  :mod:`repro_torch.core.halo_plan` backend registry on import);
* :class:`StepPipeline`: the serialized (``"off"``) and the depth-``d``
  ``"double_buffer"`` multi-step programs.
"""
from repro_torch.core.pipeline.ledger import KINDS, LedgerState, SignalLedger
from repro_torch.core.pipeline.signal_backend import SignalBackend
from repro_torch.core.pipeline.step_pipeline import (
    PIPELINE_MODES,
    StepFns,
    StepPipeline,
)

__all__ = [
    "KINDS",
    "LedgerState",
    "PIPELINE_MODES",
    "SignalBackend",
    "SignalLedger",
    "StepFns",
    "StepPipeline",
]
