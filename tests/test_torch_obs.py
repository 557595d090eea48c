"""The port's observability package against the JAX package's.

``repro_torch.obs`` keeps its own copies of the reference's pure-Python
modules (registry, gate, perfetto, CLI) and rewrites its tracing in
PyTorch's idiom.  Each test feeds the same inputs to both packages and
holds the port to the reference's outputs: the registry's records and
metrics, the Perfetto export against the reference's golden fixture
(read only) and against the reference's exporter on the same records,
the gate's findings on synthetic bench documents, and the CLI's exit
codes and lines.  The engine's emitters are held to the JAX engine's on
the same system, and the ledger summary's gauges to the reference's.
JAX is imported only through ``pytest.importorskip``.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.halo_plan import HaloSpec
from repro_torch.core.md import MDEngine, make_grappa_like
from repro_torch.core.pipeline.ledger import SignalLedger
from repro_torch.launch.mesh import make_mesh
from repro_torch.obs import (
    DEFAULT_GATE,
    KEY_FIELDS,
    NULL_TRACER,
    PHASES,
    SCHEMA_VERSION,
    MetricsRegistry,
    PhaseTracer,
    cell_key,
    compare_bench,
    default_registry,
    export_trace,
    is_obs_metric,
    iter_kind,
    jsonsafe,
    load_jsonl,
    span,
    strip_obs_metrics,
    time_fn,
    to_trace,
)
from repro_torch.obs.__main__ import main as obs_main

FIXTURES = Path(__file__).parent / "fixtures" / "obs"
AXES = ("z", "y", "x")


@pytest.fixture(scope="module")
def ref():
    """The JAX package's obs modules (skips without JAX)."""
    pytest.importorskip("jax")
    import repro.obs as robs
    from repro.obs.__main__ import main as rmain
    return robs, rmain


def _untimed(records):
    """Records without their wall-clock fields (``t``, a span's ``t0`` /
    ``dur``), which differ between any two runs."""
    out = []
    for r in records:
        r = {k: v for k, v in r.items() if k not in ("t", "t0", "dur")}
        if r.get("kind") == "snapshot":
            r["metrics"] = {k: v for k, v in r["metrics"].items()
                            if not k.startswith(("span/", "timing/"))}
        out.append(r)
    return out


def _drive_registry(reg):
    """The same instrument and record traffic on any registry."""
    reg.counter("md/steps").inc(3)
    reg.counter("md/steps").inc()
    reg.gauge("md/occ").set(0.75)
    for v in (3.0, 1.0, 2.0, 5.0):
        reg.histogram("serve/block_s").observe(v)
    reg.emit("halo_stats", backend="signal",
             data={"bytes": np.int64(4096), "occ": np.float32(0.5),
                   "dd": (2, 2, 2), "arr": np.arange(3)})
    reg.emit("pair_stats", ratio=np.float64(3.0), tiers=[(64, 8)])
    reg.snapshot(label="md/simulate", n_steps=8)
    return reg


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

def test_registry_matches_reference(ref, tmp_path):
    robs, _ = ref
    mine = _drive_registry(MetricsRegistry())
    theirs = _drive_registry(robs.MetricsRegistry())
    assert mine.metrics() == theirs.metrics()
    assert _untimed(mine.records) == _untimed(theirs.records)
    p = tmp_path / "m.jsonl"
    assert mine.to_jsonl(p) == len(mine.records)
    assert load_jsonl(p) == mine.records == robs.load_jsonl(p)
    assert iter_kind(mine.records, "pair_stats") == \
        robs.iter_kind(mine.records, "pair_stats")


def test_registry_typing_and_errors():
    reg = MetricsRegistry()
    c = reg.counter("md/steps")
    assert reg.counter("md/steps") is c
    with pytest.raises(ValueError, match="cannot decrease"):
        c.inc(-1)
    with pytest.raises(ValueError, match="is a counter"):
        reg.gauge("md/steps")
    assert default_registry() is default_registry()


@pytest.mark.parametrize("value", [
    np.int32(7), np.float32(0.25), np.arange(4).reshape(2, 2),
    torch.tensor(3), torch.tensor([1.5, 2.5]), (1, [2, {"a": 3}]),
    float("nan"),
], ids=["np-int", "np-float", "np-array", "torch-scalar", "torch-vector",
        "nested", "nan"])
def test_jsonsafe_matches_reference(ref, value):
    robs, _ = ref
    a, b = jsonsafe({"x": value}), robs.jsonsafe({"x": value})
    assert json.dumps(a) == json.dumps(b)


# --------------------------------------------------------------------------
# Perfetto export
# --------------------------------------------------------------------------

def _generic(trace):
    """A trace with its generator line taken out: the one field that
    names the package (``python -m repro_torch.obs`` here)."""
    trace = json.loads(json.dumps(trace))
    gen = trace["otherData"].pop("generator")
    assert gen in ("python -m repro_torch.obs", "python -m repro.obs")
    return trace


def test_perfetto_export_matches_golden(tmp_path):
    trace = export_trace(FIXTURES / "sample.jsonl", tmp_path / "t.json")
    golden = json.loads((FIXTURES / "trace_golden.json").read_text())
    assert trace["otherData"]["generator"] == "python -m repro_torch.obs"
    assert _generic(trace) == _generic(golden)
    assert _generic(json.loads((tmp_path / "t.json").read_text())) == \
        _generic(golden)


@pytest.mark.parametrize("n_steps", [1, 8, 24])
def test_perfetto_matches_reference_on_fixture(ref, n_steps):
    robs, _ = ref
    records = load_jsonl(FIXTURES / "sample.jsonl")
    assert _generic(to_trace(records, n_steps=n_steps)) == \
        _generic(robs.to_trace(records, n_steps=n_steps))


def test_perfetto_from_port_engine_matches_reference(ref, tmp_path):
    """A live port run's records, exported by both packages."""
    robs, _ = ref
    reg = MetricsRegistry()
    eng = MDEngine(make_grappa_like(200, seed=5, nstlist=4),
                   make_mesh((1, 1, 1), AXES),
                   HaloSpec(AXES, (1, 1, 1), backend="signal"),
                   pipeline="double_buffer", obs=reg, device="cpu")
    eng.simulate(8)
    eng.halo_stats()
    p = tmp_path / "m.jsonl"
    reg.to_jsonl(p)
    mine = export_trace(p, tmp_path / "a.json")
    theirs = robs.export_trace(p, tmp_path / "b.json")
    assert _generic(mine) == _generic(theirs)
    assert any(e.get("pid") == 1 for e in mine["traceEvents"])


# --------------------------------------------------------------------------
# gate
# --------------------------------------------------------------------------

def _bench(**over):
    cell = {"mode": "signal", "pipeline": "double_buffer",
            "pipeline_depth": 3, "devices": 1, "n_atoms": 600,
            "force_backend": "sparse", "nstprune": 4,
            "exposed_phases": 2.0, "overlapped_bytes": 4096,
            "exchanged_bytes": 6144, "halo_total_bytes": 8192,
            "dd": [1, 1, 1], "prune_ratio": 3.5,
            "evaluated_slot_pairs_per_step": 1000,
            "modeled_speedup": 2.5, "ms_per_step": 10.0,
            "ms_force_pass": 6.0}
    cell.update(over)
    return {"suite": "pipeline", "schema_version": SCHEMA_VERSION,
            "gate": DEFAULT_GATE, "cells": [cell]}


GATE_CASES = {
    "identical": {},
    "jitter": dict(ms_per_step=19.0, prune_ratio=3.51),
    "faster": dict(ms_per_step=0.1),
    "exact-drift": dict(exposed_phases=4.0),
    "rel-drift": dict(prune_ratio=5.0),
    "timing-regression": dict(ms_per_step=150.0),
    "cell-mismatch": dict(pipeline_depth=4),
    "dd-drift": dict(dd=[2, 1, 1]),
}


@pytest.mark.parametrize("over", list(GATE_CASES.values()),
                         ids=list(GATE_CASES))
def test_gate_matches_reference(ref, over):
    robs, _ = ref
    base, cur = _bench(), _bench(**over)
    assert compare_bench(base, cur) == robs.compare_bench(base, cur)


def test_gate_schema_and_keys(ref):
    robs, _ = ref
    base = _bench()
    cur = dict(base, schema_version=SCHEMA_VERSION + 1)
    assert compare_bench(base, cur) == robs.compare_bench(base, cur) == [
        f"schema_version drift: baseline {SCHEMA_VERSION} "
        f"vs current {SCHEMA_VERSION + 1}"]
    assert (SCHEMA_VERSION, KEY_FIELDS, DEFAULT_GATE) == \
        (robs.SCHEMA_VERSION, robs.KEY_FIELDS, robs.DEFAULT_GATE)
    assert cell_key(base["cells"][0]) == robs.cell_key(base["cells"][0])


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def test_cli_export_matches_reference(ref, tmp_path, capsys):
    _, rmain = ref
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    assert obs_main([str(FIXTURES / "sample.jsonl"), "--out", str(a)]) == 0
    mine = capsys.readouterr().out
    assert rmain([str(FIXTURES / "sample.jsonl"), "--out", str(b)]) == 0
    theirs = capsys.readouterr().out
    assert _generic(json.loads(a.read_text())) == \
        _generic(json.loads(b.read_text()))
    assert mine.replace(str(a), "OUT") == theirs.replace(str(b), "OUT")


@pytest.mark.parametrize("over,rc", [
    (dict(ms_per_step=12.0), 0), (dict(overlapped_bytes=1), 1),
    (dict(pipeline_depth=4), 1)], ids=["green", "exact", "mismatch"])
def test_cli_gate_matches_reference(ref, tmp_path, capsys, over, rc):
    _, rmain = ref
    base, cur = tmp_path / "base.json", tmp_path / "cur.json"
    base.write_text(json.dumps(_bench()))
    cur.write_text(json.dumps(_bench(**over)))
    args = ["gate", "--baseline", str(base), "--current", str(cur)]
    assert obs_main(args) == rc
    mine = capsys.readouterr().out
    assert rmain(args) == rc
    assert mine == capsys.readouterr().out


# --------------------------------------------------------------------------
# tracing, in PyTorch's idiom
# --------------------------------------------------------------------------

def test_span_records_duration_and_syncs():
    reg = MetricsRegistry()
    with span("work", reg, steps=4) as sp:
        y = sp.sync(torch.arange(8) * 2)
    assert sp.dur > 0.0 and int(y[-1]) == 14
    rec = iter_kind(reg.records, "span")[0]
    assert rec["name"] == "work" and rec["steps"] == 4
    assert rec["dur"] == sp.dur
    assert reg.metrics()["span/work"]["count"] == 1


def test_time_fn_medians_and_emits():
    reg = MetricsRegistry()
    calls = []

    def fn():
        calls.append(1)
        return torch.ones(4).sum()

    res = time_fn(fn, warmup=2, iters=5, name="toy", registry=reg)
    assert len(calls) == 7 and len(res.times) == 5
    assert res.best <= res.median <= max(res.times)
    assert res.median == sorted(res.times)[2]
    rec = iter_kind(reg.records, "timing")[0]
    assert rec["name"] == "toy" and rec["iters"] == 5


def test_tracer_scopes_and_obs_metrics_match_reference(ref):
    robs, _ = ref
    assert PHASES == robs.PHASES
    m = {"pe": 1.0, "obs/in_flight": 0, "obs/released": 3}
    assert strip_obs_metrics(m) == robs.strip_obs_metrics(m)
    assert [is_obs_metric(k) for k in m] == \
        [robs.is_obs_metric(k) for k in m]
    assert NULL_TRACER.step_metrics(None, None) == {}
    # an enabled tracer's per-step counters: the reference's on the same
    # ledger state (host values here)
    from repro.core.pipeline.ledger import SignalLedger as RefLedger
    lg, rlg = SignalLedger(2, 2), RefLedger(2, 2)
    st, rst = lg.init(), rlg.init()
    for kind, buf in (("fwd", 0), ("rev", 0), ("fwd", 1), ("rev", 0)):
        st, rst = lg.release(st, kind, buf), rlg.release(rst, kind, buf)
    st, rst = lg.acquire(st, "fwd", 0), rlg.acquire(rst, "fwd", 0)
    got = PhaseTracer(enabled=True).step_metrics(lg, st)
    want = robs.PhaseTracer(enabled=True).step_metrics(rlg, rst)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.int32 and int(got[k]) == int(want[k]), k
    # a scope is a profiler range around the operations issued in it
    with torch.profiler.profile() as prof:
        with NULL_TRACER.scope("force"):
            torch.ones(3).sum()
    assert any(e.name == "obs.force" for e in prof.events())


# --------------------------------------------------------------------------
# emitters: the engine, the plan and the ledger publish the reference's
# records
# --------------------------------------------------------------------------

def _engines():
    sys_ = make_grappa_like(200, seed=5, nstlist=4)
    kw = dict(pipeline="double_buffer", pipeline_depth=3,
              force_backend="sparse", nstprune=2)
    spec = HaloSpec(AXES, (1, 1, 1), backend="signal")
    reg = MetricsRegistry()
    mine = MDEngine(sys_, make_mesh((1, 1, 1), AXES), spec, obs=reg,
                    device="cpu", **kw)
    return reg, mine, sys_, kw


def test_engine_publishes_the_reference_records(ref):
    robs, _ = ref
    from repro.core.halo_plan import HaloSpec as JHaloSpec
    from repro.core.md import MDEngine as JMDEngine
    from repro.launch.mesh import make_mesh as jmake_mesh

    reg, eng, sys_, kw = _engines()
    eng.simulate(8)
    halo = eng.halo_stats()
    eng.pair_stats()
    eng.overlap_stats()
    kinds = {r["kind"] for r in reg.records}
    assert {"engine_build", "sched_update", "span", "snapshot",
            "halo_stats", "pair_stats", "overlap_model"} <= kinds
    jreg = robs.MetricsRegistry()
    jeng = JMDEngine(sys_, jmake_mesh((1, 1, 1), AXES),
                     JHaloSpec(AXES, (1, 1, 1), backend="signal"),
                     obs=jreg, **kw)
    jhalo = jeng.halo_stats()
    jeng.overlap_stats()
    build = {k: v for k, v in iter_kind(reg.records, "engine_build")[0]
             .items() if k != "t"}
    jbuild = {k: v for k, v in iter_kind(jreg.records, "engine_build")[0]
              .items() if k != "t"}
    assert build == jbuild
    assert json.dumps(jsonsafe(halo), sort_keys=True) == \
        json.dumps(robs.jsonsafe(jhalo), sort_keys=True)
    for kind in ("halo_stats", "overlap_model"):
        a = {k: v for k, v in iter_kind(reg.records, kind)[-1].items()
             if k != "t"}
        b = {k: v for k, v in iter_kind(jreg.records, kind)[-1].items()
             if k != "t"}
        assert a == b, kind
    snap = iter_kind(reg.records, "snapshot")[-1]["metrics"]
    assert snap["md/steps"]["value"] == 8 and snap["md/blocks"]["value"] == 2
    assert "span/block_dispatch" in snap and "span/rebin_dispatch" in snap
    sched = iter_kind(reg.records, "sched_update")
    assert [r["block"] for r in sched] == [1, 2]
    assert reg.metrics()["md/outer_rows"] == eng.sched_history[-1][0]
    assert reg.metrics()["md/prune_ratio"] >= 1.0


@pytest.mark.parametrize("depth,n_pulses,steps", [(2, 1, 3), (2, 3, 1),
                                                  (3, 2, 4)])
def test_ledger_summary_publishes_the_reference_gauges(ref, depth, n_pulses,
                                                       steps):
    pytest.importorskip("jax")
    from repro.core.pipeline.ledger import SignalLedger as JLedger
    robs, _ = ref
    mine, theirs = SignalLedger(depth, n_pulses), JLedger(depth, n_pulses)
    st, jst = mine.init(), theirs.init()
    for k in range(steps):
        for kind in ("fwd", "rev"):
            st = mine.acquire(mine.release(st, kind, k), kind, k)
            jst = theirs.acquire(theirs.release(jst, kind, k), kind, k)
    st = mine.release(st, "rev", steps)
    jst = theirs.release(jst, "rev", steps)
    reg, jreg = MetricsRegistry(), robs.MetricsRegistry()
    out = mine.summary(st, registry=reg, prefix="led")
    jout = theirs.summary(jst, registry=jreg, prefix="led")
    assert out == jout
    assert reg.metrics() == jreg.metrics()
    assert _untimed(reg.records) == _untimed(jreg.records)


def test_plan_publish_stats_is_stats_plus_a_record():
    reg = MetricsRegistry()
    eng = MDEngine(make_grappa_like(200, seed=5), make_mesh((1, 1, 1), AXES),
                   device="cpu", obs=reg)
    n = eng.layout.cells_per_domain
    stats = eng.plan.publish_stats(reg, n, pipeline="off")
    assert stats is eng.plan.stats(n, pipeline="off")
    rec = iter_kind(reg.records, "halo_stats")[-1]
    assert rec["critical_path"] == eng.plan.backend.critical_path
    assert rec["local_shape"] == list(n)
