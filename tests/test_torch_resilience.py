"""The port's self-healing MD runtime against the JAX package's.

On the reference's own setting (``tests/test_resilience.py``: a 300-atom
f32 system, nstlist 6, mesh (1,1,1), 18 steps, the JAX runner in
process), every plan of that file runs through both runners:

* the port's report equals the reference's (events, recoveries,
  checkpoint steps, wasted steps, the fault plan's and the ladder's
  summaries; an event's value to 1e-5 relative);
* the final states agree: ``cell_i`` bitwise, ``cell_f`` within 1e-5 of
  its scale (the f32 force tolerance of ``test_torch_md.py``: the two
  packages sum forces in other orders);
* within the port the reference's bitwise bars hold (disarmed, one-shot
  rollback and kill / resume land bitwise on the plain engine's run).

Then the unit layer on the reference's inputs, the checkpoint format
(each package reads the other's), the halo poison's entries on a 3x2x1
mesh and over lanes, the non-finite pattern of ``pair_forces_plain``
against the reference kernel, ``trace=True``'s ``obs/*`` counters, the
lane programs of an ``inject`` / ``trace`` engine, and a port-only 2x2x1
run (rollback bitwise, reshard onto (2,1,1)).
"""
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the JAX package is the reference

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.ckpt.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.compat import shard_map_norep
from repro.core.md import MDEngine as JaxMDEngine
from repro.core.md import make_grappa_like as jax_make_grappa_like
from repro.core.pipeline.step_pipeline import StepPipeline as JaxStepPipeline
from repro.kernels.nonbonded import pair_forces as jax_pair_forces
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro.obs import MetricsRegistry as JaxMetricsRegistry
from repro import resilience as jres
from repro_torch import resilience as pres
from repro_torch.ckpt import CheckpointManager
from repro_torch.convert import domains_to_cells, system_from_jax
from repro_torch.core.halo_plan import HaloPlan, HaloSpec
from repro_torch.core.md import MDEngine
from repro_torch.core.pipeline.ledger import (
    DISARMED,
    SCAN_FAULT_SITES,
    SignalLedger,
)
from repro_torch.core.pipeline.step_pipeline import StepFns, StepPipeline
from repro_torch.kernels.nonbonded import pair_forces_plain
from repro_torch.launch.mesh import make_mesh
from repro_torch.obs import MetricsRegistry
from repro_torch.resilience import ResilientMDRunner

AXES = ("z", "y", "x")
N_STEPS = 18          # 3 blocks of nstlist 6
NSTLIST = 6
REPORT_KEYS = ("recoveries", "checkpoint_steps", "wasted_steps",
               "fault_plan", "ladder", "resharded", "resumed_from")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's CPU ops on one thread (bit-stable sums, no oversubscribed
    workers)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jsys():
    return jax_make_grappa_like(300, seed=11, nstlist=NSTLIST)


@pytest.fixture(scope="module")
def psys(jsys):
    return system_from_jax(jsys)


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh((1, 1, 1), AXES)


@pytest.fixture(scope="module")
def pmesh():
    return make_mesh((1, 1, 1), AXES)


@pytest.fixture(scope="module")
def engines(jsys, psys, jmesh, pmesh):
    """One inject + health engine per package, shared by the plans."""
    return (JaxMDEngine(jsys, jmesh, inject=True, health=True),
            MDEngine(psys, pmesh, inject=True, health=True, device="cpu"))


@pytest.fixture(scope="module")
def reference(jsys, psys, jmesh, pmesh):
    """The plain engines' fault-free runs: (JAX global cells, port run)."""
    (jcf, jci), _, _ = JaxMDEngine(jsys, jmesh).simulate(N_STEPS)
    peng = MDEngine(psys, pmesh, device="cpu")
    (cf, ci), m, _ = peng.simulate(N_STEPS)
    return {"jax": (np.asarray(jcf), np.asarray(jci)),
            "cell_f": cf, "cell_i": ci, "metrics": m,
            "atoms": peng.export_atoms((cf, ci))}


def _global(state):
    return tuple(x.numpy() for x in domains_to_cells(*state))


def _run_both(engines, tmp_path, specs, **kw):
    """The same plan through both runners: ``[(state, metrics, report)
    or the exception raised, ...]`` (JAX first)."""
    out = []
    for pkg, eng in zip((jres, pres), engines):
        plan = pkg.FaultPlan([pkg.FaultSpec(*s) for s in specs])
        extra = {k: (v(pkg) if callable(v) else v) for k, v in kw.items()}
        runner = pkg.ResilientMDRunner(
            eng, tmp_path / pkg.__name__, plan=plan, **extra)
        try:
            out.append(runner.run(N_STEPS) + (runner,))
        except pkg.ResilienceError as e:
            out.append(e)
    return out


def _assert_reports_equal(jrep, prep):
    for k in REPORT_KEYS:
        assert prep[k] == jrep[k], k
    assert [(e["kind"], e["step"]) for e in prep["events"]] == \
        [(e["kind"], e["step"]) for e in jrep["events"]]
    np.testing.assert_allclose([e["value"] for e in prep["events"]],
                               [e["value"] for e in jrep["events"]],
                               rtol=1e-5)


def _assert_state_near_jax(state, jstate):
    cf, ci = _global(state)
    jcf, jci = np.asarray(jstate[0]), np.asarray(jstate[1])
    assert np.array_equal(ci, jci)
    scale = np.abs(jcf).max()
    assert np.abs(cf - jcf).max() / scale < 1e-5


def _assert_bitwise(state, reference):
    assert torch.equal(state[0], reference["cell_f"])
    assert torch.equal(state[1], reference["cell_i"])


# --------------------------------------------------------------------------
# every plan of the reference's test file, through both runners
# --------------------------------------------------------------------------

def _policy(**kw):
    return lambda pkg: pkg.RecoveryPolicy(**kw)


PLANS = [
    pytest.param([], {}, "bitwise", id="disarmed"),
    pytest.param([("halo_corrupt", 8)], {}, "bitwise", id="halo_corrupt"),
    pytest.param([("force_nan", 13)], {}, "bitwise", id="force_nan"),
    pytest.param([("signal_drop", 2)], {}, "bitwise", id="signal_drop"),
    pytest.param([("force_nan", 7)], {}, "bitwise", id="deterministic"),
    pytest.param([("signal_drop", 2, True)],
                 dict(policy=_policy(max_retries=2, backoff_base_s=0.0)),
                 "degrade", id="sticky_signal_drop"),
    pytest.param([("force_nan", 2, True)],
                 dict(policy=lambda pkg: pkg.RecoveryPolicy(
                     max_retries=0, ladder=pkg.DegradeLadder(rungs=()))),
                 "exhausted", id="unrecoverable"),
    pytest.param([("device_loss", 12)],
                 dict(spare_mesh=lambda pkg: (
                     jax_make_mesh if pkg is jres else make_mesh)(
                         (1, 1, 1), AXES)), "reshard", id="device_loss"),
    pytest.param([("device_loss", 6)], {}, "device_lost",
                 id="device_loss_no_spare"),
]


@pytest.mark.parametrize("specs,kw,outcome", PLANS)
def test_plan_matches_reference(engines, reference, tmp_path, specs, kw,
                                outcome):
    jout, pout = _run_both(engines, tmp_path, specs, **kw)
    if outcome == "exhausted":
        assert isinstance(jout, jres.RecoveryExhausted)
        assert isinstance(pout, pres.RecoveryExhausted)
        assert str(pout) == str(jout) and "nonfinite" in str(pout)
        return
    if outcome == "device_lost":
        assert isinstance(jout, jres.DeviceLost)
        assert isinstance(pout, pres.DeviceLost)
        assert str(pout) == str(jout) and "no spare" in str(pout)
        return
    (jstate, jm, jrep, jrun), (state, m, rep, run) = jout, pout
    _assert_reports_equal(jrep, rep)
    _assert_state_near_jax(state, jstate)
    assert sorted(m) == sorted(jm)
    if outcome == "bitwise":
        _assert_bitwise(state, reference)
        assert rep["checkpoint_steps"][-1] == N_STEPS
        for key in ("pe", "ke"):
            assert np.array_equal(m[key], reference["metrics"][key])
        if not specs:
            assert rep["events"] == [] and rep["recoveries"] == []
            assert rep["checkpoint_steps"] == [0, 6, 12, 18]
            assert not m["health/nonfinite"].any()
            assert not m["health/led_violation"].any()
        else:
            rec, = rep["recoveries"]
            assert rec["action"] == "rollback"
            assert 0 < rec["detection_latency_steps"] <= NSTLIST
    elif outcome == "degrade":
        assert [r["action"] for r in rep["recoveries"]] == \
            ["rollback", "rollback", "degrade"]
        assert run.engine.spec.backend == "serialized"
        assert set(rep["fault_plan"]["disabled_sites"]) == \
            {"halo_corrupt", "signal_drop"}
        # the reference's bar: the serialized backend sums the halo
        # regions in another association than the fused default
        assert torch.equal(state[1], reference["cell_i"])
        np.testing.assert_allclose(state[0].numpy(),
                                   reference["cell_f"].numpy(),
                                   atol=1e-5, rtol=1e-4)
    elif outcome == "reshard":
        assert rep["resharded"] and run.spare_mesh is None
        assert run.engine is not engines[1]
        atoms = run.engine.export_atoms(state)
        ref = reference["atoms"]
        vscale = np.abs(ref["vel"]).max()
        assert np.abs(atoms["pos"] - ref["pos"]).max() < 1e-4
        assert np.abs(atoms["vel"] - ref["vel"]).max() / vscale < 1e-4


def test_fault_runs_are_deterministic(engines, tmp_path):
    a = _run_both(engines, tmp_path / "a", [("force_nan", 7)])[1]
    b = _run_both(engines, tmp_path / "b", [("force_nan", 7)])[1]
    assert a[2]["recoveries"] == b[2]["recoveries"]
    assert a[2]["events"] == b[2]["events"]


def test_proc_kill_resumes_like_reference(engines, reference, tmp_path):
    outs = []
    for pkg, eng in zip((jres, pres), engines):
        d = tmp_path / pkg.__name__
        runner = pkg.ResilientMDRunner(
            eng, d, plan=pkg.FaultPlan([pkg.FaultSpec("proc_kill", 12)]))
        with pytest.raises(pkg.ProcessKilled, match="step 12"):
            runner.run(N_STEPS)
        outs.append(pkg.ResilientMDRunner(eng, d).run(N_STEPS))
    (jstate, _, jrep), (state, _, rep) = outs
    assert rep["resumed_from"] == jrep["resumed_from"] == 12
    _assert_reports_equal(jrep, rep)
    _assert_state_near_jax(state, jstate)
    _assert_bitwise(state, reference)


def test_forced_overflow_falls_back_like_reference(jsys, psys, jmesh, pmesh,
                                                   tmp_path):
    """Two inner-ladder overflows: warn once, two engine fallbacks, each
    following block on the outer ladder."""
    kw = dict(force_backend="sparse", nstprune=3, inject=True, health=True)
    engs = (JaxMDEngine(jsys, jmesh, obs=JaxMetricsRegistry(), **kw),
            MDEngine(psys, pmesh, obs=MetricsRegistry(), device="cpu", **kw))
    reports = []
    for pkg, eng in zip((jres, pres), engs):
        plan = pkg.FaultPlan([pkg.FaultSpec("inner_overflow", 0),
                              pkg.FaultSpec("inner_overflow", 6)])
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            state, _, report = pkg.ResilientMDRunner(
                eng, tmp_path / pkg.__name__, plan=plan).run(N_STEPS)
        assert len([w for w in rec
                    if "rolling inner prune" in str(w.message)]) == 1
        assert eng.obs.counter("md/inner_overflow_blocks").value == 2
        sched = [r for r in eng.obs.records if r.get("kind") == "sched_update"]
        assert [s["inner_disabled"] for s in sched] == [False, True, True]
        reports.append((state, report))
    (jstate, jrep), (state, rep) = reports
    _assert_reports_equal(jrep, rep)
    assert [r["action"] for r in rep["recoveries"]] == ["engine_fallback"] * 2
    assert rep["wasted_steps"] == 0
    _assert_state_near_jax(state, jstate)


def test_runner_requires_matching_engine_flags(psys, pmesh, tmp_path):
    with pytest.raises(ValueError, match="health=True"):
        ResilientMDRunner(MDEngine(psys, pmesh, device="cpu"), tmp_path)
    eng = MDEngine(psys, pmesh, health=True, device="cpu")
    with pytest.raises(ValueError, match="inject=True"):
        ResilientMDRunner(eng, tmp_path, plan=pres.FaultPlan(
            [pres.FaultSpec("force_nan", 2)]))
    with pytest.raises(ValueError, match="inject=True"):
        eng.run_block(eng.begin_run(), 2, fault_vec=[0, -1, -1])


# --------------------------------------------------------------------------
# unit layer, on the reference's inputs
# --------------------------------------------------------------------------

def test_fault_layout_and_errors_are_the_reference_s():
    from repro.core.pipeline import ledger as jledger
    assert SCAN_FAULT_SITES == jledger.SCAN_FAULT_SITES
    assert DISARMED == jledger.DISARMED
    assert pres.ALL_FAULT_SITES == jres.ALL_FAULT_SITES
    assert pres.HOST_FAULT_SITES == jres.HOST_FAULT_SITES
    for name in ("HealthTripped", "RecoveryExhausted", "DeviceLost",
                 "ProcessKilled", "WaveTimeout"):
        assert issubclass(getattr(pres, name), pres.ResilienceError)
    with pytest.raises(ValueError, match="unknown fault site"):
        pres.FaultSpec("cosmic_ray", 3)
    with pytest.raises(ValueError, match="step"):
        pres.FaultSpec("force_nan", -1)


@pytest.mark.parametrize("seed,n_steps,n_faults,sites", [
    (7, 100, 5, None), (8, 100, 5, None), (0, 60, 3, None),
    (3, 18, 4, "all"), (11, 1, 2, "all")])
def test_fault_plan_from_seed_draws_the_reference_s(seed, n_steps, n_faults,
                                                    sites):
    kw = {} if sites is None else {"sites": pres.ALL_FAULT_SITES}
    a = pres.FaultPlan.from_seed(seed, n_steps, n_faults=n_faults, **kw)
    b = jres.FaultPlan.from_seed(seed, n_steps, n_faults=n_faults, **kw)
    assert [vars(s) for s in a.specs] == [vars(s) for s in b.specs]


def _plan_trace(pkg):
    plan = pkg.FaultPlan([pkg.FaultSpec("halo_corrupt", 8),
                          pkg.FaultSpec("signal_drop", 2, sticky=True),
                          pkg.FaultSpec("proc_kill", 13),
                          pkg.FaultSpec("force_nan", 9),
                          pkg.FaultSpec("force_nan", 11),
                          pkg.FaultSpec("inner_overflow", 4),
                          pkg.FaultSpec("device_loss", 16)])
    out = []
    for lo in (0, 6, 6, 12, 12):
        fv, armed = plan.arm_scan(lo, lo + 6)
        out.append((None if fv is None else fv.tolist(), armed,
                    plan.overflow_armed(lo, lo + 6),
                    [(i, s.site) for i, s in plan.host_pending(lo, lo + 6)]))
        plan.mark_fired(armed)
    plan.disable_sites(["signal_drop"])
    fv, armed = plan.arm_scan(12, 18)
    out.append((None if fv is None else fv.tolist(), armed))
    return out, plan.summary(), plan.scan_or_overflow_sites, repr(plan)


def test_fault_plan_windows_and_retirement_match_reference():
    assert _plan_trace(pres) == _plan_trace(jres)


def _monitor_trace(pkg):
    mon = pkg.HealthMonitor(energy_spike_rel=0.25)
    pe, ke = np.full(4, -100.0), np.full(4, 40.0)
    pe2 = pe.copy()
    pe2[2:] -= 30.0
    blocks = [
        ({"health/nonfinite": np.array([0, 0, 3, 9]),
          "health/led_violation": np.array([1])}, 12),
        ({"health/nonfinite": np.zeros(4)}, 18),
        ({"pe": pe, "ke": ke}, 0),
        ({"pe": pe2, "ke": ke}, 4),
        ({"pe": pe, "ke": ke}, 4),
        ({"pe": np.array([np.nan, -100.0]), "ke": np.array([40.0, 40.0]),
          "health/nonfinite": np.array([5, 0])}, 8),
        ({"pe": np.full(2, -130.0), "ke": np.full(2, 40.0)}, 10),
    ]
    out = []
    for i, (m, s0) in enumerate(blocks):
        if i == 6:
            mon.reset()
        out.append([vars(e) for e in mon.check_block(m, s0)])
    return out


def test_health_monitor_matches_reference():
    assert _monitor_trace(pres) == _monitor_trace(jres)
    reg = MetricsRegistry()
    pres.HealthMonitor(registry=reg).check_block(
        {"health/nonfinite": np.array([0, 2])}, 6)
    assert reg.counter("resilience/nonfinite").value == 1


def _policy_trace(pkg):
    pol = pkg.RecoveryPolicy(max_retries=2, backoff_base_s=0.01,
                             backoff_factor=2.0, backoff_cap_s=0.03)
    out = [pol.backoff(a) for a in range(6)]
    for kinds in ({"nonfinite"}, {"ledger"}, {"energy_spike"},
                  {"overflow"}, {"device_loss"}, {"ledger", "nonfinite"},
                  set()):
        for attempt in range(4):
            act = pol.decide(kinds, attempt)
            out.append((act.kind, act.backoff_s,
                        act.rung.name if act.rung else None))
    lad = pkg.DegradeLadder()
    for kinds in ({"ledger"}, {"overflow"}, {"nonfinite"}, set()):
        r = lad.next_rung(kinds)
        out.append(dataclass_tuple(r))
        lad.apply(r)
    out.append(lad.next_rung({"ledger"}))
    out.append(lad.summary())
    with pytest.raises(ValueError, match="max_retries"):
        pkg.RecoveryPolicy(max_retries=-1)
    return out


def dataclass_tuple(r):
    return (r.name, r.overrides, r.triggers, r.clears)


def test_recovery_policy_and_ladder_match_reference():
    assert _policy_trace(pres) == _policy_trace(jres)
    assert [dataclass_tuple(r) for r in pres.DEFAULT_RUNGS] == \
        [dataclass_tuple(r) for r in jres.DEFAULT_RUNGS]


def test_watchdog_matches_reference():
    def trace(pkg):
        ev = []
        wd = pkg.Watchdog(alpha=0.5, threshold=3.0, warmup=2,
                          on_straggler=lambda s, dt, ew: ev.append((s, dt)))
        for i, dt in enumerate([0.1, 0.1, 0.1, 0.1, 1.0, 0.1, 0.9, 0.1]):
            wd.observe(i, dt)
        return ev, wd.events, wd.ewma, wd.n
    assert trace(pres) == trace(jres)


def test_ledger_release_dropped_matches_reference():
    from repro.core.pipeline.ledger import SignalLedger as JaxSignalLedger
    for depth, pulses in ((1, 1), (2, 2), (3, 1)):
        pl, jl = SignalLedger(depth, pulses), JaxSignalLedger(depth, pulses)
        p, j = pl.init(), jl.init()
        for k in range(5):
            for kind in ("fwd", "rev"):
                drop = kind == "rev" and k in (1, 3)
                p = pl.release_dropped(p, kind, k, drop)
                j = jl.release_dropped(j, kind, k, jnp.bool_(drop))
                p = pl.acquire(p, kind, k)
                j = jl.acquire(j, kind, k)
        for a, b in zip(p, j):
            assert np.array_equal(a, np.asarray(b))
        assert pl.consistent(p) == bool(jl.consistent(j)) is False


# --------------------------------------------------------------------------
# checkpoints: the reference's contract and file format
# --------------------------------------------------------------------------

def _tree(seed=0, n=5):
    rng = np.random.default_rng(seed)
    return {"cell_f": rng.standard_normal((2, 3, 2, 4, 7)).astype(np.float32),
            "cell_i": rng.integers(-1, 50, (2, 3, 2, 4, 2)).astype(np.int32),
            "atoms": {"pos": rng.standard_normal((n, 3)),
                      "vel": rng.standard_normal((n, 3)).astype(np.float32)},
            "pair": (np.arange(3, dtype=np.int64), np.float32(2.5) *
                     np.ones(2, np.float32))}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_as_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _leaves_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _leaves_equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _leaves_equal(x, y)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_checkpoint_roundtrip_and_keep_n(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = _tree()
    for step in (3, 7, 9):
        mgr.save(step, _as_torch(tree), extra={"step": step})
    assert mgr.all_steps() == [7, 9] and mgr.latest_valid_step() == 9
    assert mgr.manifest(9)["extra"] == {"step": 9}
    assert mgr.last_save["bytes"] == sum(
        np.asarray(x).nbytes for x in (tree["cell_f"], tree["cell_i"],
                                       *tree["atoms"].values(),
                                       *tree["pair"]))
    step, got = mgr.restore_latest(tree)
    assert step == 9
    _leaves_equal(got, tree)
    like = _as_torch(tree)
    like = {**like, "cell_f": torch.empty(like["cell_f"].shape,
                                          device="meta")}
    got = mgr.restore(7, like, device="cpu")
    assert isinstance(got["cell_f"], torch.Tensor)
    _leaves_equal({k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                   for k, v in got.items() if k != "atoms" and k != "pair"},
                  {k: tree[k] for k in ("cell_f", "cell_i")})
    bad = dict(tree, cell_f=np.zeros((2, 3, 2, 4, 6), np.float32))
    with pytest.raises(ValueError, match="shape mismatch for cell_f"):
        mgr.restore(9, bad)


def test_checkpoint_skips_corrupt_and_partial_writes(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=5, async_save=True)
    for step in (1, 2, 3):
        mgr.save(step, _tree(step))
    mgr.wait()
    shard = tmp_path / "step_0000000003" / "shard_0.npz"
    shard.write_bytes(shard.read_bytes()[:100])        # truncated
    (tmp_path / "step_0000000002" / "manifest.json").write_text("{")
    (tmp_path / ".tmp_step_0000000004_1").mkdir()       # a crashed write
    (tmp_path / "step_junk").mkdir()
    assert mgr.latest_valid_step() == 1
    step, got = mgr.restore_latest(_tree())
    assert step == 1
    _leaves_equal(got, _tree(1))
    assert CheckpointManager(tmp_path / "empty").restore_latest(_tree()) \
        is None


def test_each_package_reads_the_other_s_checkpoints(tmp_path):
    tree = _tree(4)
    CheckpointManager(tmp_path / "port").save(5, _as_torch(tree),
                                              extra={"step": 5})
    JaxCheckpointManager(tmp_path / "jax").save(5, tree, extra={"step": 5})
    for d in ("port", "jax"):
        jm, pm = JaxCheckpointManager(tmp_path / d), \
            CheckpointManager(tmp_path / d)
        assert jm.manifest(5)["keys"] == pm.manifest(5)["keys"] == \
            ["atoms/pos", "atoms/vel", "cell_f", "cell_i", "pair/0", "pair/1"]
        _leaves_equal(jm.restore(5, tree), tree)
        _leaves_equal(pm.restore(5, tree), tree)
        assert jm.latest_valid_step() == pm.latest_valid_step() == 5


# --------------------------------------------------------------------------
# the injection seams
# --------------------------------------------------------------------------

def _trivial_fns():
    return StepFns(begin=lambda s, f, c: (s, None, s),
                   force=lambda e, c: (e.clone(), {}),
                   finish=lambda s, a, f, c: (s, f, {}))


class _JaxPlanStub:
    """What the reference's ``_poison_halo`` reads of its pipeline."""

    class plan:
        class spec:
            axis_names = AXES


@pytest.mark.parametrize("lanes", [None, 2])
def test_halo_poison_hits_the_reference_s_entries(lanes):
    mesh = make_mesh((3, 2, 1), AXES)
    plan = HaloPlan.build(HaloSpec(AXES, (1, 1, 1), backend="serialized"),
                          mesh, device="cpu")
    if lanes:
        plan = plan.with_lanes(lanes)
    pipe = StepPipeline(plan, _trivial_fns(), mode="off")
    g = torch.Generator().manual_seed(0)
    lead = (lanes,) if lanes else ()
    payload = torch.rand(lead + (3, 2, 1, 2, 3, 2, 5, 4), generator=g)
    ext = plan.fwd_local(payload)
    got = torch.isnan(pipe._poison_halo(ext, payload)).numpy()
    assert not torch.isnan(ext).any() and got.any()
    for idx in np.ndindex(*(lead + (3, 2, 1))):
        want = JaxStepPipeline._poison_halo(
            _JaxPlanStub, jnp.asarray(ext[idx].numpy()),
            jnp.asarray(payload[idx].numpy()), jnp.bool_(True))
        assert np.array_equal(got[idx], np.isnan(np.asarray(want)))


@pytest.mark.parametrize("use_counts", [False, True])
def test_pair_forces_plain_nan_pattern_matches_reference_kernel(jsys, psys,
                                                                use_counts):
    """NaN and Inf coordinates (a halo cell NaN'd whole, single slots and
    components, an Inf, a NaN charge) poison what the reference kernel's
    0 * dx poisons, in forces and energies."""
    rng = np.random.default_rng(5)
    N, K = 6, 8
    a = rng.uniform(0, 1.5, (N, K, 4)).astype(np.float32)
    b = rng.uniform(0, 1.5, (N, K, 4)).astype(np.float32)
    b[0] = np.nan                  # a received halo cell
    a[1, 3, 0] = np.nan            # one component of one slot
    b[2, 7, 2] = np.inf            # an Inf in a padded slot
    a[3, 0, 3] = np.nan            # a NaN charge
    b[4, 5, 1] = -np.inf
    ta = rng.integers(-1, 2, (N, K)).astype(np.int32)
    tb = rng.integers(-1, 2, (N, K)).astype(np.int32)
    same = np.array([0, 0, 1, 0, 0, 0], np.int32)
    cnt_a = np.array([8, 5, 3, 8, 2, 6], np.int32)
    cnt_b = np.array([8, 8, 3, 4, 6, 1], np.int32)
    kw = dict(cnt_a=cnt_a, cnt_b=cnt_b) if use_counts else {}
    want = jax_pair_forces(jnp.asarray(a), jnp.asarray(b), jnp.asarray(ta),
                           jnp.asarray(tb), jnp.asarray(same),
                           jsys.params.ff,
                           interpret=True,
                           **{k: jnp.asarray(v) for k, v in kw.items()})
    got = pair_forces_plain(*(torch.from_numpy(x) for x in (a, b, ta, tb,
                                                            same)),
                            psys.params.ff,
                            **{k: torch.from_numpy(v) for k, v in kw.items()})
    for g, w in zip(got, want):
        assert np.array_equal(~np.isfinite(g.numpy()),
                              ~np.isfinite(np.asarray(w)))
    assert (~np.isfinite(got[0].numpy())).any()
    assert (~np.isfinite(got[1].numpy())).any()


def test_disarmed_inject_and_trace_are_bitwise_neutral(psys, pmesh,
                                                       reference):
    for kw in (dict(inject=True), dict(trace=True),
               dict(inject=True, trace=True, health=True,
                    obs=MetricsRegistry())):
        eng = MDEngine(psys, pmesh, device="cpu", **kw)
        (cf, ci), m, _ = eng.simulate(N_STEPS)
        _assert_bitwise((cf, ci), reference)
        for key in ("pe", "ke", "mom"):
            assert np.array_equal(m[key], reference["metrics"][key])


@pytest.mark.parametrize("kw", [
    pytest.param({}, id="off"),
    pytest.param(dict(pipeline="double_buffer", pipeline_depth=3),
                 id="double_buffer3"),
    pytest.param(dict(force_backend="sparse", nstprune=3), id="nstprune3"),
])
def test_trace_obs_counters_match_reference(jsys, psys, jmesh, pmesh, kw):
    jreg, preg = JaxMetricsRegistry(), MetricsRegistry()
    _, jm, _ = JaxMDEngine(jsys, jmesh, trace=True, obs=jreg,
                           **kw).simulate(12)
    eng = MDEngine(psys, pmesh, trace=True, obs=preg, device="cpu", **kw)
    _, m, _ = eng.simulate(12)
    keys = sorted(k for k in jm if k.startswith("obs/"))
    assert keys == sorted(k for k in m if k.startswith("obs/")) and keys
    for k in keys:
        assert m[k].dtype == np.int32 and np.array_equal(m[k], jm[k]), k
    # the host recount: each step's ledger totals
    assert (m["obs/released"] >= m["obs/acquired"]).all()
    jrec, = [r for r in jreg.records if r.get("kind") == "step_counters"]
    prec, = [r for r in preg.records if r.get("kind") == "step_counters"]
    assert sorted(prec["data"]) == sorted(jrec["data"])
    for k in prec["data"]:
        assert np.array_equal(np.asarray(prec["data"][k]),
                              np.asarray(jrec["data"][k]))


def test_inject_overlap_rebin_and_bad_fault_vec_refused(psys, pmesh):
    with pytest.raises(ValueError, match="overlap_rebin"):
        MDEngine(psys, pmesh, inject=True, overlap_rebin=True, device="cpu")
    eng = MDEngine(psys, pmesh, inject=True, device="cpu")
    with pytest.raises(ValueError, match="fault_vec must have shape"):
        eng.run_block(eng.begin_run(), 2, fault_vec=[0, 1])


def _jax_local_block(eng, n_steps):
    """The reference's ``local_programs["block"]`` under its shard_map."""
    spec = P(*AXES)
    fn = shard_map_norep(lambda f, i, fo: eng.local_programs["block"](
        f, i, fo, n_steps), mesh=eng.mesh, in_specs=(spec,) * 3,
        out_specs=(spec, spec, spec, P()))
    cf, ci, force, _ = eng.rebin_fn(*eng.init_state())
    return jax.jit(fn)(cf, ci, force)


def test_lane_programs_of_inject_and_trace_engines(jsys, psys, jmesh, pmesh):
    """What the reference's ``local_programs`` does: an inject engine's
    block has no fault vector and raises ``KeyError('fault_vec')``; a
    trace engine's block carries each step's ``obs/*`` counters (the same
    for every lane)."""
    with pytest.raises(KeyError, match="fault_vec"):
        _jax_local_block(JaxMDEngine(jsys, jmesh, inject=True), 3)
    eng = MDEngine(psys, pmesh, inject=True, device="cpu")
    lp = eng.lane_programs(2)
    cf, ci = (torch.stack([x, x]) for x in eng.init_state())
    cf, ci, force, _ = lp["rebin"](cf, ci)
    with pytest.raises(KeyError, match="fault_vec"):
        lp["block"](cf, ci, force, 3)

    _, _, _, jm = _jax_local_block(JaxMDEngine(jsys, jmesh, trace=True), 3)
    lp = MDEngine(psys, pmesh, trace=True, device="cpu").lane_programs(2)
    _, _, _, m = lp["block"](cf, ci, force, 3)
    for k in (k for k in jm if k.startswith("obs/")):
        assert m[k].shape == (2, 3)
        for lane in range(2):
            assert np.array_equal(m[k][lane].numpy(), np.asarray(jm[k])), k


# --------------------------------------------------------------------------
# port only: a decomposed mesh
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dd_runs(psys, tmp_path_factory):
    """2x2x1: the plain run, a one-shot rollback and a reshard onto
    (2,1,1)."""
    mesh = make_mesh((2, 2, 1), AXES)
    kw = dict(spec=HaloSpec(AXES, (1, 1, 1), backend="signal"),
              pipeline="double_buffer", pipeline_depth=3, device="cpu")
    (cf, ci), _, _ = MDEngine(psys, mesh, **kw).simulate(N_STEPS)
    eng = MDEngine(psys, mesh, inject=True, health=True, **kw)
    out = {"plain": (cf, ci), "engine": eng}
    for name, spec, spare in (
            ("rollback", ("halo_corrupt", 9), None),
            ("reshard", ("device_loss", 12), make_mesh((2, 1, 1), AXES))):
        runner = ResilientMDRunner(
            eng, tmp_path_factory.mktemp(name),
            plan=pres.FaultPlan([pres.FaultSpec(*spec)]), spare_mesh=spare)
        out[name] = runner.run(N_STEPS) + (runner,)
    return out


def test_dd_rollback_is_bitwise(dd_runs):
    state, _, rep, _ = dd_runs["rollback"]
    assert [r["action"] for r in rep["recoveries"]] == ["rollback"]
    assert rep["events"][0]["kind"] == "nonfinite"
    assert rep["events"][0]["step"] == 9
    assert torch.equal(state[0], dd_runs["plain"][0])
    assert torch.equal(state[1], dd_runs["plain"][1])


def test_dd_reshard_onto_fewer_domains(dd_runs, psys):
    state, _, rep, runner = dd_runs["reshard"]
    assert rep["resharded"] and runner.engine.axis_sizes == (2, 1, 1)
    assert rep["checkpoint_steps"] == [0, 6, 12, 12, 18]
    eng = dd_runs["engine"]
    atoms = runner.engine.export_atoms(state)
    ref = eng.export_atoms(dd_runs["plain"])
    ids = state[1][..., 0]
    assert int((ids >= 0).sum()) == psys.n_atoms
    vscale = np.abs(ref["vel"]).max()
    assert np.abs(atoms["pos"] - ref["pos"]).max() < 1e-4
    assert np.abs(atoms["vel"] - ref["vel"]).max() / vscale < 1e-4
