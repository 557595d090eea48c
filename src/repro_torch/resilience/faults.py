"""Typed errors of the resilience layer (the serving subset).

Copies of the reference's ``ResilienceError`` and ``WaveTimeout``
(``src/repro/resilience/faults.py``); the fault plans come later.
"""
from __future__ import annotations


class ResilienceError(RuntimeError):
    """Base of the resilience layer's typed exceptions."""


class WaveTimeout(ResilienceError):
    """A serving wave's decode loop exceeded its per-wave deadline."""
