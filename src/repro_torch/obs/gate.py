"""Perf-trajectory gate: drift check against a checked-in bench baseline.

The port of the JAX package's ``obs/gate.py`` (pure Python, a copy).  A
bench file is a schema-versioned JSON document of cells (step latency,
exposed phases, overlapped bytes, prune ratio across backend x pipeline
mode x depth); a committed copy is the trajectory baseline, and
:func:`compare_bench` (``python -m repro_torch.obs gate``) checks a fresh
file against it.

Three comparison classes, declared in the baseline's ``gate`` section so
the tolerance travels with the data it gates:

* ``exact`` — schedule/model invariants (exposed phases, overlapped and
  exchanged bytes, decomposition).  These are *deterministic functions
  of the code*; any drift is a semantic change and must be an explicit
  baseline update in the same change.
* ``rel_tol`` — deterministic-but-float quantities (prune ratio,
  evaluated pairs) allowed a small relative envelope.
* ``timing_factor`` — wall-clock keys (``ms_per_step``,
  ``ms_force_pass``) only fail when the current run is *slower* than
  baseline by more than the factor: machines are noisy, so the gate
  catches trajectory-scale regressions, not jitter.
"""
from __future__ import annotations

import json
from typing import Dict, List, Tuple

SCHEMA_VERSION = 1

# identity of one bench cell inside a suite file
KEY_FIELDS = ("mode", "pipeline", "pipeline_depth", "devices", "n_atoms",
              "force_backend", "nstprune")

DEFAULT_GATE = {
    "exact": ["exposed_phases", "overlapped_bytes", "exchanged_bytes",
              "halo_total_bytes", "dd"],
    "rel_tol": {"prune_ratio": 0.05,
                "evaluated_slot_pairs_per_step": 0.05,
                "modeled_speedup": 1e-6},
    "timing_factor": 10.0,
    "timing_keys": ["ms_per_step", "ms_force_pass"],
}


def cell_key(cell: dict, key_fields: Tuple[str, ...] = KEY_FIELDS) -> Tuple:
    return tuple(cell.get(f) for f in key_fields)


def _index(bench: dict,
           key_fields: Tuple[str, ...] = KEY_FIELDS) -> Dict[Tuple, dict]:
    out: Dict[Tuple, dict] = {}
    for cell in bench.get("cells", []):
        key = cell_key(cell, key_fields)
        if key in out:
            raise ValueError(f"duplicate bench cell {key}")
        out[key] = cell
    return out


def _fmt_key(key: Tuple,
             key_fields: Tuple[str, ...] = KEY_FIELDS) -> str:
    return "/".join(f"{f}={v}" for f, v in zip(key_fields, key))


def compare_bench(baseline: dict, current: dict) -> List[str]:
    """All drift findings of ``current`` vs ``baseline`` ('' = pass)."""
    problems: List[str] = []
    if baseline.get("schema_version") != current.get("schema_version"):
        problems.append(
            f"schema_version drift: baseline "
            f"{baseline.get('schema_version')} vs current "
            f"{current.get('schema_version')}")
        return problems
    gate = {**DEFAULT_GATE, **baseline.get("gate", {})}
    # suites whose cells have a different identity (e.g. the resilience
    # suite keys on fault site x recovery mode) declare their own
    # key_fields in the gate section, next to the tolerances
    kf = tuple(gate.get("key_fields", KEY_FIELDS))
    base_cells, cur_cells = _index(baseline, kf), _index(current, kf)
    for key in sorted(set(base_cells) - set(cur_cells), key=repr):
        problems.append(
            f"cell missing from current run: {_fmt_key(key, kf)}")
    for key in sorted(set(cur_cells) - set(base_cells), key=repr):
        problems.append(
            f"cell not in baseline (update it): {_fmt_key(key, kf)}")
    for key in sorted(set(base_cells) & set(cur_cells), key=repr):
        b, c = base_cells[key], cur_cells[key]
        where = _fmt_key(key, kf)
        for f in gate["exact"]:
            if b.get(f) != c.get(f):
                problems.append(f"{where}: {f} drift "
                                f"{b.get(f)!r} -> {c.get(f)!r} (exact)")
        for f, tol in gate["rel_tol"].items():
            bv, cv = b.get(f), c.get(f)
            if bv is None and cv is None:
                continue
            if bv is None or cv is None:
                problems.append(f"{where}: {f} drift {bv!r} -> {cv!r}")
                continue
            scale = max(abs(bv), abs(cv), 1e-12)
            if abs(bv - cv) > tol * scale:
                problems.append(f"{where}: {f} drift {bv:.6g} -> {cv:.6g} "
                                f"(rel {abs(bv - cv) / scale:.3g} > {tol})")
        for f in gate["timing_keys"]:
            bv, cv = b.get(f), c.get(f)
            if bv is None or cv is None:
                continue
            if cv > bv * gate["timing_factor"]:
                problems.append(
                    f"{where}: {f} regression {bv:.3f} -> {cv:.3f} ms "
                    f"(> {gate['timing_factor']}x baseline)")
    return problems


def gate_files(baseline_path, current_path) -> List[str]:
    with open(baseline_path) as fh:
        baseline = json.load(fh)
    with open(current_path) as fh:
        current = json.load(fh)
    return compare_bench(baseline, current)
