"""The parts of the reference's resilience layer that serving needs.

``WaveTimeout`` (with its base ``ResilienceError``) and ``Watchdog``; the
fault plans, monitors, degrade ladder and runner come with the MD
resilience work.
"""
from repro_torch.resilience.faults import ResilienceError, WaveTimeout
from repro_torch.resilience.policy import Watchdog

__all__ = ["ResilienceError", "WaveTimeout", "Watchdog"]
