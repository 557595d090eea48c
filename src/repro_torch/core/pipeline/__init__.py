"""Multi-step programs over a halo plan (serialized mode in this slice)."""
from repro_torch.core.pipeline.step_pipeline import (
    PIPELINE_MODES,
    StepFns,
    StepPipeline,
)

__all__ = ["PIPELINE_MODES", "StepFns", "StepPipeline"]
