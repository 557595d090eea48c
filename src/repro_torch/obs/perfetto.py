"""Chrome/Perfetto ``trace.json`` export — the repo's Fig. 6 analogue.

Renders a metrics JSONL (written by :class:`~repro_torch.obs.registry.
MetricsRegistry`) as a Chrome trace-event file with two process lanes:

* **pid 0 — measured**: every host-side ``span`` record becomes a
  duration event (one thread row per span name, wall-clock placement),
  and every ``snapshot`` record's counters/gauges become counter tracks.

* **pid 1 — predicted**: a synthetic per-step timeline built from the
  latest ``halo_stats`` record's alpha-beta latency model and overlap
  model — per-step forward/reverse exchanges split into *exposed* and
  *overlapped* rows around the force window, exactly the decomposition
  the paper's profiler timelines show for MPI vs NVSHMEM.  ``obs/*``
  per-step ledger counters (from a ``step_counters`` record) ride along
  as counter tracks on the predicted step grid.

Open the output at https://ui.perfetto.dev (or ``chrome://tracing``).
Reading the lanes: if the measured step wall time tracks
``predicted exposed + force`` the overlap model holds; a measured lane
longer than predicted-with-overlap but matching predicted-serialized
means the exchange is still on the critical path.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.obs.registry import iter_kind, load_jsonl  # noqa: F401

_US = 1e6   # trace-event timestamps are microseconds


def _meta(pid: int, name: str, tid: Optional[int] = None,
          tname: Optional[str] = None) -> List[dict]:
    evs = [{"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": name}}]
    if tid is not None:
        evs.append({"ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_name", "args": {"name": tname}})
    return evs


def _measured_events(records: List[dict]) -> List[dict]:
    spans = iter_kind(records, "span")
    snaps = iter_kind(records, "snapshot")
    events: List[dict] = _meta(0, "measured (host spans)")
    if not spans and not snaps:
        return events
    starts = [r["t"] - r.get("dur", 0.0) for r in spans] + \
             [r["t"] for r in snaps]
    t_base = min(starts)
    tids = {name: i + 1
            for i, name in enumerate(sorted({r["name"] for r in spans}))}
    for name, tid in tids.items():
        events += _meta(0, "", tid=tid, tname=f"span:{name}")[1:]
    for rec in spans:
        dur = float(rec.get("dur", 0.0))
        args = {k: v for k, v in rec.items()
                if k not in ("kind", "t", "t0", "name", "dur")}
        events.append({
            "ph": "X", "pid": 0, "tid": tids[rec["name"]],
            "name": rec["name"],
            "ts": (rec["t"] - dur - t_base) * _US,
            "dur": max(dur * _US, 0.01),
            "args": args,
        })
    for rec in snaps:
        ts = (rec["t"] - t_base) * _US
        for mname, m in sorted(rec.get("metrics", {}).items()):
            val = m.get("value")
            if isinstance(val, dict):       # histogram state -> mean track
                val = val.get("mean")
            if isinstance(val, (int, float)):
                events.append({"ph": "C", "pid": 0, "tid": 0, "name": mname,
                               "ts": ts, "args": {mname: val}})
    return events


def predicted_schedule(halo: dict, n_steps: int,
                       bench: Optional[dict] = None) -> dict:
    """Deterministic per-step phase layout from the analytic models.

    ``halo`` is a ``halo_stats`` record (``data`` holds the plan stats,
    ``critical_path`` the backend's chained-bytes model).  Durations are
    seconds; the caller scales to trace microseconds.
    """
    data = halo.get("data", halo)
    lat, ov = data["latency"], data["overlap"]
    fused = halo.get("critical_path", "serialized") == "fused"
    t_dir = lat["fused_time_s"] if fused else lat["serialized_time_s"]
    exposed = float(ov["exposed_phases_per_step"])
    stages = (exposed + float(ov["overlapped_phases_per_step"])) / 2.0
    exposed_frac = (exposed / (2.0 * stages)) if stages else 1.0
    t_comm = 2.0 * t_dir                       # fwd + rev per step
    t_exposed = t_comm * exposed_frac
    if bench and bench.get("ms_force_pass") is not None:
        t_force = float(bench["ms_force_pass"]) / 1e3
    elif bench and bench.get("ms_per_step") is not None:
        t_force = max(float(bench["ms_per_step"]) / 1e3 - t_exposed, 0.0)
    else:
        t_force = 3.0 * t_dir                  # model units: no measurement
    t_step = max(t_exposed + t_force, 1e-9)
    return {
        "n_steps": int(n_steps),
        "pipeline": ov["pipeline"],
        "depth": ov["depth"],
        "critical_path": "fused" if fused else "serialized",
        "t_step_s": t_step,
        "t_force_s": t_force,
        "t_exposed_s": t_exposed,
        "t_hidden_s": max(t_comm - t_exposed, 0.0),
        "overlapped_bytes_per_step": ov["overlapped_bytes_per_step"],
        "exchanged_bytes_per_step": ov["exchanged_bytes_per_step"],
    }


def _predicted_events(records: List[dict], n_steps: int) -> List[dict]:
    halos = iter_kind(records, "halo_stats")
    if not halos:
        return []
    halo = halos[-1]
    benches = iter_kind(records, "bench")
    steps = iter_kind(records, "step_counters")
    if steps:
        counters = steps[-1].get("data", {})
        n = max((len(v) for v in counters.values()), default=n_steps)
        n_steps = n or n_steps
    else:
        counters = {}
    sched = predicted_schedule(halo, n_steps,
                               benches[-1] if benches else None)
    t_step, t_force = sched["t_step_s"], sched["t_force_s"]
    t_exp, t_hid = sched["t_exposed_s"], sched["t_hidden_s"]
    args = {k: v for k, v in sched.items() if k != "n_steps"}

    events = _meta(1, "predicted (alpha-beta + overlap model)")
    for tid, tname in ((1, "comm exposed"), (2, "compute"),
                       (3, "comm overlapped")):
        events += _meta(1, "", tid=tid, tname=tname)[1:]
    for i in range(n_steps):
        t0 = i * t_step
        if t_exp > 0:
            events.append({"ph": "X", "pid": 1, "tid": 1, "name": "fwd halo",
                           "ts": t0 * _US, "dur": (t_exp / 2) * _US,
                           "args": args})
            events.append({"ph": "X", "pid": 1, "tid": 1, "name": "rev halo",
                           "ts": (t0 + t_exp / 2 + t_force) * _US,
                           "dur": (t_exp / 2) * _US, "args": args})
        events.append({"ph": "X", "pid": 1, "tid": 2,
                       "name": "force + integrate",
                       "ts": (t0 + t_exp / 2) * _US, "dur": t_force * _US,
                       "args": args})
        if t_hid > 0:
            events.append({"ph": "X", "pid": 1, "tid": 3,
                           "name": "overlapped halo",
                           "ts": (t0 + t_exp / 2) * _US,
                           "dur": min(t_hid, max(t_force, 1e-9)) * _US,
                           "args": args})
        for mname, vals in sorted(counters.items()):
            if i < len(vals):
                events.append({"ph": "C", "pid": 1, "tid": 0, "name": mname,
                               "ts": t0 * _US, "args": {mname: vals[i]}})
    return events


def to_trace(records: List[dict], n_steps: int = 8) -> dict:
    """Build the Chrome trace-event document from registry records."""
    events = _measured_events(records) + _predicted_events(records, n_steps)
    other: Dict[str, object] = {"generator": "python -m repro_torch.obs",
                                "n_records": len(records)}
    halos = iter_kind(records, "halo_stats")
    if halos:
        other["backend"] = halos[-1].get("backend")
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}


def export_trace(jsonl_path, out_path, n_steps: int = 8) -> dict:
    """JSONL in, ``trace.json`` out; returns the trace document."""
    trace = to_trace(load_jsonl(jsonl_path), n_steps=n_steps)
    with open(out_path, "w") as fh:
        json.dump(trace, fh, indent=1, sort_keys=True)
    return trace
