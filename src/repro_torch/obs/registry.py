"""Typed metrics registry with per-block snapshots and JSONL export.

The port of the JAX package's ``obs/registry.py`` (pure Python, a copy).

The repo's observability spine: every layer that used to return a bare
stats dict (``MDEngine.halo_stats`` / ``overlap_stats`` / ``pair_stats``,
``SignalLedger.summary``, ``HaloPlan.stats``, the inner-prune overflow
monitor,
``engine.sched_history``) still does — and *also* publishes the same
numbers here as typed instruments and structured records, so one JSONL
file carries the whole run:

* :class:`Counter` / :class:`Gauge` / :class:`Histogram` — live,
  get-or-create instruments (``registry.counter("md/steps").inc(8)``);
* :meth:`MetricsRegistry.emit` — append a structured record (``kind`` +
  free-form JSON-safe fields): halo/overlap/pair stats, schedule
  updates, host-side spans;
* :meth:`MetricsRegistry.snapshot` — freeze every instrument's current
  value into one record (the per-block heartbeat);
* :meth:`MetricsRegistry.to_jsonl` — one record per line, the input
  format of the Perfetto exporter (``python -m repro_torch.obs``).

Instruments are process-local and lock-protected; records are plain
dicts so the file format stays greppable and diff-able.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, Iterable, List, Optional


def jsonsafe(value: Any) -> Any:
    """Recursively coerce numpy scalars/arrays and tuples to JSON types."""
    if isinstance(value, dict):
        return {str(k): jsonsafe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [jsonsafe(v) for v in value]
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    if hasattr(value, "tolist"):          # numpy / torch scalars and arrays
        return jsonsafe(value.tolist())
    if hasattr(value, "item"):
        return jsonsafe(value.item())
    return repr(value)


class Counter:
    """Monotone integer counter (events, steps, overflow blocks)."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> int:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        self.value += int(n)
        return self.value

    def state(self) -> Any:
        return self.value


class Gauge:
    """Last-write-wins scalar (schedule rows, prune ratio, occupancy)."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None

    def set(self, v: float) -> float:
        self.value = float(v)
        return self.value

    def state(self) -> Any:
        return self.value


class Histogram:
    """Streaming distribution (span durations, per-block timings)."""

    kind = "histogram"

    def __init__(self, name: str):
        self.name = name
        self.values: List[float] = []

    def observe(self, v: float) -> None:
        self.values.append(float(v))

    @property
    def count(self) -> int:
        return len(self.values)

    def state(self) -> Any:
        if not self.values:
            return {"count": 0}
        vs = sorted(self.values)
        n = len(vs)
        return {
            "count": n,
            "sum": sum(vs),
            "min": vs[0],
            "max": vs[-1],
            "mean": sum(vs) / n,
            "p50": vs[n // 2],
            "p95": vs[min(n - 1, (19 * n) // 20)],
        }


_INSTRUMENTS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Instruments + an append-only record log, exported as JSONL."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, Any] = {}
        self._records: List[dict] = []

    # -- instruments (get-or-create; kind clashes are programming errors) --

    def _instrument(self, kind: str, name: str):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = _INSTRUMENTS[kind](name)
                self._instruments[name] = inst
            elif inst.kind != kind:
                raise ValueError(
                    f"metric {name!r} is a {inst.kind}, not a {kind}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._instrument("counter", name)

    def gauge(self, name: str) -> Gauge:
        return self._instrument("gauge", name)

    def histogram(self, name: str) -> Histogram:
        return self._instrument("histogram", name)

    # -- records -----------------------------------------------------------

    def emit(self, kind: str, **fields) -> dict:
        """Append one structured record (fields are made JSON-safe)."""
        rec = {"kind": str(kind), "t": time.time()}
        rec.update(jsonsafe(fields))
        with self._lock:
            self._records.append(rec)
        return rec

    def snapshot(self, label: str = "", **extra) -> dict:
        """Freeze every instrument's current state into one record."""
        with self._lock:
            metrics = {name: {"kind": inst.kind, "value": inst.state()}
                       for name, inst in sorted(self._instruments.items())}
        return self.emit("snapshot", label=label, metrics=metrics, **extra)

    @property
    def records(self) -> List[dict]:
        with self._lock:
            return list(self._records)

    def metrics(self) -> Dict[str, Any]:
        """Flat ``name -> current value`` view (for tables/tests)."""
        with self._lock:
            return {name: inst.state()
                    for name, inst in sorted(self._instruments.items())}

    def clear(self) -> None:
        with self._lock:
            self._instruments.clear()
            self._records.clear()

    # -- persistence -------------------------------------------------------

    def to_jsonl(self, path) -> int:
        """Write every record as one JSON line; returns the line count."""
        recs = self.records
        with open(path, "w") as fh:
            for rec in recs:
                fh.write(json.dumps(rec, sort_keys=True) + "\n")
        return len(recs)


def load_jsonl(path) -> List[dict]:
    """Read a registry JSONL file back into a record list."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def iter_kind(records: Iterable[dict], kind: str) -> List[dict]:
    return [r for r in records if r.get("kind") == kind]


_default: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-wide registry engines publish to unless given one."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default
