"""Static comm-schedule verifier of the port (no linter: that checks JAX
code).  :func:`gate_pipeline_build` and :func:`gate_md_build` are the
build-time gates of ``StepPipeline.build`` and ``MDEngine.__init__``."""
from repro_torch.analysis.grids import full_grid, pr4_grid, pr5_prune_grid
from repro_torch.analysis.schedule_verifier import (
    VERIFY_MODES,
    CommEvent,
    ConfigError,
    EventSegment,
    ScheduleConfig,
    ScheduleReport,
    ScheduleVerificationError,
    Violation,
    check_halo_config,
    check_md_config,
    extract_events,
    gate_md_build,
    gate_pipeline_build,
    gate_schedule,
    probe_steps,
    verify_build,
    verify_schedule,
)

__all__ = [
    "VERIFY_MODES", "CommEvent", "EventSegment", "Violation",
    "ScheduleConfig", "ScheduleReport", "ConfigError",
    "ScheduleVerificationError", "check_halo_config", "check_md_config",
    "extract_events", "gate_md_build", "gate_pipeline_build",
    "gate_schedule", "probe_steps", "verify_build", "verify_schedule",
    "full_grid", "pr4_grid", "pr5_prune_grid",
]
