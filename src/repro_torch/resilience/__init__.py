"""repro_torch.resilience: fault injection, health monitors, self-healing MD.

Light imports by design: the runner (which pulls in the MD engine) loads
lazily, so ``from repro_torch.resilience.faults import WaveTimeout``
stays cheap for the serving path.
"""
from repro_torch.resilience.faults import (
    ALL_FAULT_SITES,
    HOST_FAULT_SITES,
    DeviceLost,
    FaultPlan,
    FaultSpec,
    HealthTripped,
    ProcessKilled,
    RecoveryExhausted,
    ResilienceError,
    WaveTimeout,
)
from repro_torch.resilience.monitors import HealthEvent, HealthMonitor
from repro_torch.resilience.policy import (
    DEFAULT_RUNGS,
    DegradeLadder,
    DegradeRung,
    RecoveryAction,
    RecoveryPolicy,
    Watchdog,
)

__all__ = [
    "ALL_FAULT_SITES", "HOST_FAULT_SITES", "DeviceLost", "FaultPlan",
    "FaultSpec", "HealthTripped", "ProcessKilled", "RecoveryExhausted",
    "ResilienceError", "WaveTimeout", "HealthEvent", "HealthMonitor",
    "DEFAULT_RUNGS", "DegradeLadder", "DegradeRung", "RecoveryAction",
    "RecoveryPolicy", "Watchdog", "ResilientMDRunner",
]


def __getattr__(name):          # PEP 562: lazy heavy import
    if name == "ResilientMDRunner":
        from repro_torch.resilience.runner import ResilientMDRunner
        return ResilientMDRunner
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
