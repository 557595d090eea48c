"""The MD server on the port: replica lanes against solo port runs.

The reference's contract (``tests/test_serve_md.py``) is bitwise: a
replica served as a lane of a bucketed batch equals a solo
:class:`MDEngine` run of the same system (same seed, the bucket's box,
``layout_atoms`` and, pruned, ``static_ladder``) element for element,
whatever its co-residents, admission order or neighbours' retirement.
The reference's own server does not run on this JAX version (ROADMAP C,
notes), so every lane here is held to a solo run of the port, and the
solo engine's serving knobs (``layout_atoms``, ``static_ladder``,
``health``, ``on_boundary``) are held to the JAX engine's on the same
numpy inputs.  The buckets and the scheduler are held to the
reference's modules on the same event sequences.

Also here: the compile-count contract under churn, NaN quarantine,
cancel, evacuate / resume, deadlines, submit validation, budget
rounding, a mesh with an axis of size 3, ``health`` / ``obs`` bitwise
neutral, and on the card (``cuda``) lanes against solo runs.  JAX is
imported only through ``pytest.importorskip``, inside the tests that
compare with it, so the ``cuda`` tests also run where JAX is absent.
"""
import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.convert import cells_to_domains
from repro_torch.core.halo_plan import HaloSpec
from repro_torch.core.md import MDEngine, make_grappa_like
from repro_torch.launch import serve as serve_launch
from repro_torch.launch.mesh import make_mesh
from repro_torch.obs import MetricsRegistry
from repro_torch.resilience import WaveTimeout
from repro_torch.runtime.serve_loop import masked_tokens
from repro_torch.serve import (BucketLadder, CANCELLED, DONE, FAILED,
                               PREEMPTED, TERMINAL, ReplicaFault, SimServer,
                               SimScheduler, padding_waste)

AXES = ("z", "y", "x")
NST = 10            # block quantum: nstlist steps per dispatch
BUCKET = 256        # canonical atom bucket for most cells
# the shared replica roster: (n_atoms, seed); sub-bucket sizes exercise
# padded lanes, distinct seeds make cross-lane leaks visible
R0, R1, R2 = (200, 5), (256, 7), (230, 9)
MATRIX = [(fb, pipe) for fb in ("dense", "sparse")
          for pipe in ("off", "double_buffer")]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one CPU thread, so parallel test workers do not
    contend for cores (restored for the next module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape=(1, 1, 1)):
    return make_mesh(shape, AXES)


@functools.lru_cache(maxsize=None)
def _sys(n_atoms, seed, box=BUCKET, nst=NST):
    return make_grappa_like(n_atoms, seed=seed, nstlist=nst, box_atoms=box)


@functools.lru_cache(maxsize=None)
def _solo(fb, pipe, n_atoms, seed, n_steps, mesh=(1, 1, 1), box=BUCKET,
          backend="fused"):
    """A replica's solo port run under the bucket's box and layout."""
    eng = MDEngine(_sys(n_atoms, seed, box), _mesh(mesh),
                   HaloSpec(AXES, (1, 1, 1), backend=backend),
                   force_backend=fb, pipeline=pipe,
                   static_ladder=(fb != "dense"), layout_atoms=box,
                   device="cpu")
    (cf, ci), _, _ = eng.simulate(n_steps)
    return cf.numpy(), ci.numpy()


def _server(fb="dense", pipe="off", rows=(1, 2, 4), atoms=(BUCKET,),
            mesh=(1, 1, 1), backend="fused", **kw):
    return SimServer(_mesh(mesh),
                     BucketLadder(row_buckets=rows, atom_buckets=atoms),
                     block_steps=NST,
                     engine_kwargs={"force_backend": fb, "pipeline": pipe,
                                    "spec": HaloSpec(AXES, (1, 1, 1),
                                                     backend=backend)},
                     device="cpu", **kw)


def _assert_bitwise(out, fb, pipe, spec, n_steps, **solo_kw):
    cf, ci = _solo(fb, pipe, *spec, n_steps, **solo_kw)
    assert np.array_equal(out["cell_f"], cf), \
        f"cell_f diverged for replica {spec} under {fb}/{pipe}"
    assert np.array_equal(out["cell_i"], ci), \
        f"cell_i diverged for replica {spec} under {fb}/{pipe}"


# --------------------------------------------------------------------------
# buckets and scheduler against the reference's modules
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_serve():
    pytest.importorskip("jax")
    from repro.serve import buckets as rb
    from repro.serve import scheduler as rs
    return rb, rs


@pytest.mark.parametrize("rows,atoms", [
    ((1, 2, 4, 8, 16), (192, 256)), ((2, 4), (64, 128, 256)), ((1,), (45,))],
    ids=["default", "three-atoms", "one-rung"])
def test_buckets_match_reference(ref_serve, rows, atoms):
    rb, _ = ref_serve
    mine = BucketLadder(row_buckets=rows, atom_buckets=atoms)
    theirs = rb.BucketLadder(row_buckets=rows, atom_buckets=atoms)
    assert mine.n_buckets == theirs.n_buckets
    for demand in range(0, 20):
        assert mine.rows_for(demand) == theirs.rows_for(demand)
    for n in range(1, atoms[-1] + 1, 7):
        assert mine.atom_bucket_for(n) == theirs.atom_bucket_for(n)
        b, rbk = mine.bucket_for(3, n), theirs.bucket_for(3, n)
        assert (b.key, str(b)) == (rbk.key, str(rbk))
        assert padding_waste(b, [n, n // 2]) == \
            rb.padding_waste(rbk, [n, n // 2])
    for bad in (atoms[-1] + 1, 10 ** 6):
        with pytest.raises(ValueError, match="exceeds the largest"):
            mine.atom_bucket_for(bad)
    with pytest.raises(ValueError, match="ascending"):
        BucketLadder(row_buckets=(2, 1))


def _transcript(sched_cls, ladder, ops, fault_every):
    """Drive a scheduler through ``ops``; every observable after each op."""
    sched = sched_cls(ladder, block_steps=NST)
    out, rids = [], []
    for kind, a, b in ops:
        if kind == "submit":
            rids.append(sched.submit(n_atoms=a, n_steps=b))
        elif kind == "cancel" and rids:
            out.append(("cancel", sched.cancel(rids[a % len(rids)])))
        elif kind == "boundary":
            for adm in sched.tick():
                out.append(("admit", adm.shape, adm.row, adm.rid))
            for shape in sched.live_shapes():
                sched.advance(shape)
                out.append(("occ", shape, sched.occupancy(shape),
                            sched.occupants(shape)))
                if fault_every:
                    for _, rid in sched.occupants(shape):
                        if rid % fault_every == 0:
                            sched.mark_fault(rid, RuntimeError("boom"))
                for rid in sched.finished(shape):
                    out.append(("release", rid, sched.release(rid).status))
        out.append(("pending", sched.pending()))
    out.append(("records", [(r.rid, r.status, r.steps_done, r.budget_steps,
                             r.atom_bucket, r.shape, r.row)
                            for r in sched.records.values()]))
    out.append(("touched", sorted(sched.shapes_touched)))
    return out


@pytest.mark.parametrize("seed", range(12))
def test_scheduler_matches_reference_on_random_events(ref_serve, seed):
    rb, rs = ref_serve
    rng = np.random.RandomState(seed)
    ops = []
    for _ in range(rng.randint(10, 60)):
        u = rng.rand()
        if u < 0.45:
            ops.append(("submit", int(rng.randint(1, 257)),
                        int(rng.randint(1, 46))))
        elif u < 0.55:
            ops.append(("cancel", int(rng.randint(0, 64)), 0))
        else:
            ops.append(("boundary", 0, 0))
    ops += [("boundary", 0, 0)] * 30
    rows, atoms = (1, 2, 4), (64, 128, 256)
    fault_every = seed % 3
    mine = _transcript(SimScheduler, BucketLadder(rows, atoms), ops,
                       fault_every)
    theirs = _transcript(rs.SimScheduler, rb.BucketLadder(rows, atoms), ops,
                         fault_every)
    assert mine == theirs
    assert all(r[1] in TERMINAL for r in mine[-2][1])


# --------------------------------------------------------------------------
# replica isolation: every lane equals its solo run, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fb,pipe", MATRIX,
                         ids=[f"{fb}-{pipe}" for fb, pipe in MATRIX])
def test_batched_replicas_bitwise_match_solo(fb, pipe):
    """Three mixed-size replicas in one 4-row bucket (one lane empty)."""
    srv = _server(fb, pipe)
    handles = [(spec, srv.submit(_sys(*spec), 20))
               for spec in (R0, R1, R2)]
    srv.drain()
    for spec, h in handles:
        assert h.status == DONE
        _assert_bitwise(h.result(), fb, pipe, spec, 20)
    st = srv.stats()
    assert st["replicas_done"] == 3 and st["useful_steps"] == 60


@pytest.mark.parametrize("backend", ["pallas", "signal"])
def test_lanes_on_a_mesh_with_an_axis_of_size_3(backend):
    """A 3x1x1 mesh: the halo's roll signs show only on an axis of size
    3 or more; two lanes of the pruned path against their solo runs."""
    box = 600
    specs = [(560, 3), (600, 4)]
    srv = SimServer(_mesh((3, 1, 1)),
                    BucketLadder(row_buckets=(2,), atom_buckets=(box,)),
                    block_steps=NST,
                    engine_kwargs={"force_backend": "pallas",
                                   "spec": HaloSpec(AXES, (1, 1, 1),
                                                    backend=backend)},
                    device="cpu")
    handles = [(s, srv.submit(_sys(*s, box=box), 20)) for s in specs]
    srv.drain()
    for spec, h in handles:
        _assert_bitwise(h.result(), "pallas", "off", spec, 20,
                        mesh=(3, 1, 1), box=box, backend=backend)


@pytest.mark.parametrize("order", [(R0, R1, R2), (R2, R0, R1), (R1, R2, R0)],
                         ids=["012", "201", "120"])
def test_admission_order_is_invisible(order):
    """A 2-row bucket forces churn (the third replica waits for a freed
    row); every admission order gives the same bitwise trajectories."""
    srv = _server("sparse", "off", rows=(1, 2))
    handles = [(spec, srv.submit(_sys(*spec), 20)) for spec in order]
    srv.drain()
    for spec, h in handles:
        _assert_bitwise(h.result(), "sparse", "off", spec, 20)


def test_mid_run_neighbor_retirement_is_invisible():
    """Mixed budgets in a 2-row bucket: the short replica retires
    mid-run, a queued one takes its row, the long one never notices."""
    srv = _server("dense", "off", rows=(1, 2))
    ha = srv.submit(_sys(*R0), 40)
    hb = srv.submit(_sys(*R1), 20)
    hc = srv.submit(_sys(*R2), 30)
    srv.drain()
    _assert_bitwise(ha.result(), "dense", "off", R0, 40)
    _assert_bitwise(hb.result(), "dense", "off", R1, 20)
    _assert_bitwise(hc.result(), "dense", "off", R2, 30)
    st = srv.stats()
    assert st["compiles"] == 1 and st["shapes_touched"] == [(2, BUCKET)]


def test_compile_count_equals_buckets_touched():
    """32 replicas churned through 4 shapes: the shapes whose batch
    programs were built equal the shapes touched, exactly."""
    ladder = BucketLadder(row_buckets=(2, 4), atom_buckets=(192, 256))
    srv = SimServer(_mesh(), ladder, block_steps=NST,
                    engine_kwargs={"force_backend": "dense"}, device="cpu")
    batches = ([(2, 192), (4, 192), (2, 256), (4, 256)] * 2
               + [(4, 192), (4, 256)])
    total = 0
    for count, atoms in batches:
        for i in range(count):
            srv.submit(make_grappa_like(atoms - (i % 2) * 8, seed=total,
                                        nstlist=NST, box_atoms=atoms), NST)
            total += 1
        srv.drain()     # the table closes empty: the next batch reopens
    assert total == 32
    st = srv.stats()
    assert st["replicas_done"] == 32
    touched = set(srv.scheduler.shapes_touched)
    assert touched == {(2, 192), (4, 192), (2, 256), (4, 256)}
    assert st["compiles"] == len(touched) == len(srv._programs)


# --------------------------------------------------------------------------
# faults, cancel, evacuate / resume, guardrails
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fb", ["dense", "sparse"])
def test_nan_replica_quarantined_not_the_batch(fb):
    """A poisoned lane retires with a typed ReplicaFault at its block
    boundary; its co-resident finishes bitwise unchanged."""
    bad_sys = make_grappa_like(200, seed=11, nstlist=NST, box_atoms=BUCKET)
    bad_sys.vel[0] = np.inf
    srv = _server(fb, "off")
    h_ok = srv.submit(_sys(*R1), 20)
    h_bad = srv.submit(bad_sys, 20)
    srv.drain()
    assert h_bad.status == FAILED
    with pytest.raises(ReplicaFault, match="non-finite"):
        h_bad.result()
    assert h_ok.status == DONE
    _assert_bitwise(h_ok.result(), fb, "off", R1, 20)
    st = srv.stats()
    assert st["replicas_failed"] == 1 and st["replicas_done"] == 1


def test_block_deadline_raises_wave_timeout():
    srv = _server("dense", "off", wave_timeout_s=1e-9)
    srv.submit(_sys(*R0), NST)
    with pytest.raises(WaveTimeout):
        srv.run_cycle()


def test_cancel_queued_and_running():
    srv = _server("dense", "off", rows=(1,))
    h_run = srv.submit(_sys(*R0), 40)
    h_q = srv.submit(_sys(*R1), 20)      # 1-row bucket: stays queued
    assert h_q.cancel() == CANCELLED
    assert h_q.result() is None
    srv.run_cycle()                      # block 1 of the running replica
    assert h_run.cancel() == "running"   # flagged; retires next boundary
    srv.drain()
    assert h_run.status == CANCELLED
    out = h_run.result()                 # partial state: exactly 1 block
    assert out["steps"] == NST
    _assert_bitwise(out, "dense", "off", R0, NST)


def test_evacuate_and_resume_is_bitwise():
    """Preempt a replica mid-run, readmit its snapshot on a fresh server:
    the stitched trajectory equals an uninterrupted solo run."""
    srv = _server("dense", "off")
    h = srv.submit(_sys(*R2), 30)
    srv.run_cycle()
    [(h_old, snap)] = srv.evacuate()
    assert h_old.status == PREEMPTED
    assert snap["steps"] == NST and snap["remaining_steps"] == 20
    srv2 = _server("dense", "off")
    h2 = srv2.submit(_sys(*R2), snap["remaining_steps"],
                     state=(snap["cell_f"], snap["cell_i"]))
    srv2.drain()
    _assert_bitwise(h2.result(), "dense", "off", R2, 30)
    with pytest.raises(ValueError, match="resume state shape"):
        srv2.submit(_sys(*R2), 10, state=(snap["cell_f"][..., :1, :],
                                          snap["cell_i"]))


def test_submit_validates_box_and_cadence():
    srv = _server("dense", "off")
    with pytest.raises(ValueError, match="box_atoms"):
        srv.submit(make_grappa_like(200, seed=1, nstlist=NST), 20)
    with pytest.raises(ValueError, match="nstlist"):
        srv.submit(make_grappa_like(256, seed=1, nstlist=20), 20)
    with pytest.raises(ValueError, match="atom bucket"):
        srv.submit(make_grappa_like(400, seed=1, nstlist=NST), 20)
    for key in ("layout_atoms", "health", "static_ladder", "nstprune",
                "device"):
        with pytest.raises(ValueError, match="server-managed"):
            SimServer(_mesh(), engine_kwargs={key: 1}, device="cpu")


def test_step_budget_rounds_up_to_blocks():
    srv = _server("dense", "off")
    h = srv.submit(_sys(*R0), 15)        # 1.5 blocks -> 2 blocks run
    srv.drain()
    out = h.result()
    assert out["steps"] == 20 and out["requested_steps"] == 15
    assert srv.stats()["useful_steps"] == masked_tokens([20], [15]) == 15
    atoms = out["atoms"]
    assert atoms["pos"].shape == (200, 3) and atoms["vel"].shape == (200, 3)


def test_rep_sharded_mesh_is_refused():
    """The reference's ('rep', z, y, x) mesh shards rows over devices:
    multi-GPU work, refused by the single-card port."""
    mesh = make_mesh((2, 1, 1, 1), ("rep",) + AXES)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        SimServer(mesh, device="cpu")
    with pytest.raises(ValueError, match="mesh axes"):
        SimServer(make_mesh((1, 1), ("a", "b")), device="cpu")


def test_server_defaults_to_the_card_and_never_falls_back():
    if torch.cuda.is_available():
        srv = SimServer(_mesh())
        assert srv.device.type == "cuda"
        assert srv._template(BUCKET).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        SimServer(_mesh())
    with pytest.raises(RuntimeError, match="cuda"):
        serve_launch.main(["--md", "--replicas", "1", "--steps", "10"])


def test_launcher_serves_md_on_cpu(capsys):
    stats = serve_launch.main(["--md", "--device", "cpu", "--replicas",
                               "2", "--steps", "10", "--backend", "pallas"])
    assert stats["replicas_done"] == 2 and stats["compiles"] == 1
    out = capsys.readouterr().out
    assert "served 2 replicas (20 useful steps)" in out
    assert "1 compiles over shapes [(2, 256)]" in out


# --------------------------------------------------------------------------
# the solo knobs: bitwise neutral, and against the JAX engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fb,pipe", MATRIX,
                         ids=[f"{fb}-{pipe}" for fb, pipe in MATRIX])
def test_health_and_obs_are_bitwise_neutral(fb, pipe):
    s = _sys(*R0)
    kw = dict(force_backend=fb, pipeline=pipe, static_ladder=(fb != "dense"),
              layout_atoms=BUCKET, device="cpu")
    (cf, ci), m, d = MDEngine(s, _mesh(), **kw).simulate(20)
    reg = MetricsRegistry()
    (cf2, ci2), m2, d2 = MDEngine(s, _mesh(), health=True, obs=reg,
                                  **kw).simulate(20)
    assert torch.equal(cf, cf2) and torch.equal(ci, ci2) and d == d2
    for k in m:
        assert np.array_equal(m[k], m2[k]), k
    assert m2["health/nonfinite"].shape == (20,)
    assert not m2["health/nonfinite"].any()
    assert m2["health/led_violation"].shape == (2,)
    assert not m2["health/led_violation"].any()
    assert reg.metrics()["md/steps"] == 20


def test_trace_and_inject_raise_naming_their_items():
    """trace and inject are ported: at the serve shapes they build and a
    run keeps its bits; what still raises is the reference's: inject with
    overlap_rebin, and static_ladder with nstprune."""
    kw = dict(layout_atoms=BUCKET, device="cpu")
    (cf, ci), m, _ = MDEngine(_sys(*R0), _mesh(), **kw).simulate(10)
    for knob in ("trace", "inject"):
        (cf2, ci2), m2, _ = MDEngine(_sys(*R0), _mesh(), **{knob: True},
                                     **kw).simulate(10)
        assert torch.equal(cf, cf2) and torch.equal(ci, ci2)
        for k in m:
            assert np.array_equal(m[k], m2[k]), k
        assert ("obs/in_flight" in m2) == (knob == "trace")
    with pytest.raises(ValueError, match="overlap_rebin"):
        MDEngine(_sys(*R0), _mesh(), inject=True, overlap_rebin=True,
                 device="cpu")
    with pytest.raises(ValueError, match="nstprune"):
        MDEngine(_sys(*R0), _mesh(), force_backend="sparse",
                 static_ladder=True, nstprune=2, device="cpu")


@contextlib.contextmanager
def _x64():
    """JAX in float64 for the f64 comparisons (restored after)."""
    import jax
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    from repro.core.md import MDEngine as JMDEngine
    from repro.core.md import make_grappa_like as jmake
    from repro.launch.mesh import make_mesh as jmake_mesh
    return JMDEngine, jmake, jmake_mesh


@pytest.mark.parametrize("n,box", [(200, 256), (256, 256), (150, 192),
                                   (900, 1600)])
def test_layout_atoms_matches_jax(jx, n, box):
    JMDEngine, jmake, jmake_mesh = jx
    mine = MDEngine(make_grappa_like(n, seed=1, box_atoms=box), _mesh(),
                    layout_atoms=box, device="cpu")
    theirs = JMDEngine(jmake(n, seed=1, box_atoms=box),
                       jmake_mesh((1, 1, 1), AXES), layout_atoms=box)
    assert dataclasses.astuple(mine.layout) == \
        dataclasses.astuple(theirs.layout)
    assert mine.mig_cap == theirs.mig_cap
    plain = MDEngine(make_grappa_like(n, seed=1, box_atoms=box), _mesh(),
                     device="cpu")
    assert plain.layout.capacity <= mine.layout.capacity


def _f64(n, seed, nst=8):
    return make_grappa_like(n, seed=seed, nstlist=nst, box_atoms=BUCKET,
                            dtype=np.float64)


def _close(a, b, tol=1e-9):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)) < tol


def test_static_ladder_matches_jax(jx):
    """24 f64 steps of the pruned path on the static ladder: the same
    ladder at every prune, PE / KE to 1e-9 relative."""
    JMDEngine, jmake, jmake_mesh = jx
    s = _f64(*R0)
    mine = MDEngine(s, _mesh(), force_backend="sparse", static_ladder=True,
                    layout_atoms=BUCKET, device="cpu")
    _, m, _ = mine.simulate(24)
    with _x64():
        theirs = JMDEngine(s, jmake_mesh((1, 1, 1), AXES),
                           force_backend="sparse", static_ladder=True,
                           layout_atoms=BUCKET)
        _, jm, _ = theirs.simulate(24)
    assert mine.sched_history == theirs.sched_history
    assert len(set(mine.sched_history)) == 1
    assert mine._sched_exec[1] == tuple(tuple(t) for t in
                                        theirs._sched_exec[1])
    M = mine.pair_schedule.n_pairs
    assert mine.sched_history[0][0] >= M
    for k in ("pe", "ke"):
        assert _close(m[k], jm[k]), k


def test_health_counts_and_boundary_steps_match_jax(jx):
    """``health``'s per-step and per-invocation counts and
    ``on_boundary``'s call steps against the JAX engine, on the same
    numpy state, clean and with a NaN velocity."""
    JMDEngine, jmake, jmake_mesh = jx
    s = _f64(*R0)
    mine = MDEngine(s, _mesh(), health=True, layout_atoms=BUCKET,
                    device="cpu")
    calls, jcalls = [], []
    _, m, _ = mine.simulate(24, on_boundary=lambda rs: calls.append(rs.step))
    with _x64():
        theirs = JMDEngine(s, jmake_mesh((1, 1, 1), AXES), health=True,
                           layout_atoms=BUCKET)
        _, jm, _ = theirs.simulate(
            24, on_boundary=lambda rs: jcalls.append(rs.step))
    assert calls == jcalls == [8, 16]
    for k in ("health/nonfinite", "health/led_violation"):
        assert np.array_equal(m[k], np.asarray(jm[k]).reshape(m[k].shape)), k
    for k in ("pe", "ke"):
        assert _close(m[k], jm[k]), k
    # a NaN velocity: the same counts per step for one block
    cf, ci = (np.array(a) for a in mine.bin_host())
    first = np.argwhere(ci[..., 0] == 0)[0]
    cf[tuple(first)][4] = np.nan
    state = tuple(torch.as_tensor(np.ascontiguousarray(a))
                  for a in cells_to_domains(cf, ci, (1, 1, 1)))
    _, m, _ = mine.simulate(8, state=state)
    import jax.numpy as jnp
    with _x64():
        _, jm, _ = theirs.simulate(8, state=(jnp.asarray(cf),
                                             jnp.asarray(ci)))
    assert m["health/nonfinite"].any()
    assert np.array_equal(m["health/nonfinite"],
                          np.asarray(jm["health/nonfinite"]))


def test_engine_boundary_hook_fires_and_mutates():
    eng = MDEngine(_sys(*R0), _mesh(), device="cpu")
    calls = []
    eng.simulate(3 * NST, on_boundary=lambda rs: calls.append(rs.step))
    assert calls == [NST, 2 * NST]       # interior boundaries only

    def freeze(rs):
        cf = rs.cell_f.clone()
        cf[..., 4:7] = 0.0
        rs.cell_f = cf
    (cf2, _), _, _ = eng.simulate(2 * NST, on_boundary=freeze)
    (cf1, _), _, _ = eng.simulate(2 * NST)
    assert not torch.equal(cf1, cf2)
    eng_ovr = MDEngine(_sys(*R0), _mesh(), overlap_rebin=True, device="cpu")
    with pytest.raises(ValueError, match="overlap_rebin"):
        eng_ovr.simulate(2 * NST, on_boundary=lambda rs: None)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fb,pipe", MATRIX,
                         ids=[f"{fb}-{pipe}" for fb, pipe in MATRIX])
def test_cuda_lanes_match_solo_runs(cuda_device, fb, pipe):
    """On the card, through the kernels and the step graphs: three lanes
    of a 4-row bucket against their solo runs, bitwise, and a second
    wave on the warm shape capturing no graph."""
    spec = HaloSpec(AXES, (1, 1, 1), backend="pallas")
    srv = SimServer(_mesh(), BucketLadder(row_buckets=(4,),
                                          atom_buckets=(BUCKET,)),
                    block_steps=NST,
                    engine_kwargs={"force_backend": fb, "pipeline": pipe,
                                   "spec": spec})
    for wave in range(2):
        handles = [(s, srv.submit(_sys(*s), 40)) for s in (R0, R1, R2)]
        srv.drain()
        if wave == 0:
            captures = srv.stats()["captures_by_shape"]
    assert srv.stats()["captures_by_shape"] == captures
    for s, h in handles:
        eng = MDEngine(_sys(*s), _mesh(), spec, force_backend=fb,
                       pipeline=pipe, static_ladder=(fb != "dense"),
                       layout_atoms=BUCKET)
        (cf, ci), _, _ = eng.simulate(40)
        out = h.result()
        assert np.array_equal(out["cell_f"], cf.cpu().numpy())
        assert np.array_equal(out["cell_i"], ci.cpu().numpy())
