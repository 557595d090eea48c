"""Static analysis of the port: the comm-schedule verifier and the
hazard linter for its PyTorch and CUDA sources (:mod:`.lint`; both run
by ``python -m repro_torch.analysis``).  :func:`gate_pipeline_build` and
:func:`gate_md_build` are the build-time gates of ``StepPipeline.build``
and ``MDEngine.__init__``."""
from repro_torch.analysis.grids import full_grid, pr4_grid, pr5_prune_grid
from repro_torch.analysis.lint import (RULES, Diagnostic, Rule,
                                       iter_source_files, lint_file,
                                       lint_paths)
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
    "RULES", "Rule", "Diagnostic", "lint_file", "lint_paths",
    "iter_source_files",
]
