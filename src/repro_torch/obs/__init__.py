"""repro_torch.obs: metrics registry, phase tracing, Perfetto export, perf gate.

The port of the JAX package's ``obs`` package; it imports nothing of
that package.

* :mod:`repro_torch.obs.registry` — typed counters / gauges / histograms
  with per-block snapshots and JSONL export; the engine's stats surfaces
  (``halo_stats`` / ``overlap_stats`` / ``pair_stats``, ledger summaries,
  ``sched_history``, the overflow monitor) and the MD server publish here.
* :mod:`repro_torch.obs.tracing` — ``torch.profiler.record_function``
  phase ranges and the host-side ``span`` / ``time_fn`` timing API, each
  synchronizing the CUDA device before its clock stops.
* :mod:`repro_torch.obs.perfetto` — metrics JSONL -> Chrome/Perfetto
  ``trace.json`` with measured and model-predicted lanes side by side
  (``python -m repro_torch.obs metrics.jsonl --out trace.json``).
* :mod:`repro_torch.obs.gate` — drift check of a fresh bench file
  against a checked-in baseline (``python -m repro_torch.obs gate``).
"""
from repro_torch.obs.gate import (
    DEFAULT_GATE,
    KEY_FIELDS,
    SCHEMA_VERSION,
    cell_key,
    compare_bench,
    gate_files,
)
from repro_torch.obs.perfetto import export_trace, predicted_schedule, to_trace
from repro_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    iter_kind,
    jsonsafe,
    load_jsonl,
)
from repro_torch.obs.tracing import (
    NULL_TRACER,
    PHASES,
    PhaseTracer,
    Span,
    TimingResult,
    block_until_ready,
    is_obs_metric,
    span,
    strip_obs_metrics,
    time_fn,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry", "iter_kind", "jsonsafe", "load_jsonl",
    "NULL_TRACER", "PHASES", "PhaseTracer", "Span", "TimingResult",
    "block_until_ready", "is_obs_metric", "span", "strip_obs_metrics",
    "time_fn",
    "export_trace", "predicted_schedule", "to_trace",
    "DEFAULT_GATE", "KEY_FIELDS", "SCHEMA_VERSION", "cell_key",
    "compare_bench", "gate_files",
]
