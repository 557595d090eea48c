"""The port's MD slice against the JAX MDEngine: host geometry, binning,
rebin / migration and f32 forces, a short NVE run, the engine's knobs.

Bitwise where the work is data movement (system builder, binning,
rebin / migration), to stated tolerances where it is arithmetic:
* f32 forces: 1e-5 of the force scale against JAX (summation order
  differs), 5e-5 against the O(N^2) direct oracle; PE to 1e-5 relative.
The 24-step f64 trajectories are in ``tests/test_torch_md_trajectories.py``
(1x1x1 against JAX in process, and the port's halo backends and pipelines
against each other) and ``tests/test_torch_md_2x2x2.py`` (a 2x2x2 mesh
against an 8-virtual-device JAX run in a subprocess).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the JAX package is the reference

import jax.numpy as jnp  # noqa: E402

from _torch_md_common import (  # noqa: E402
    AXES,
    _diag_rows,
    _jax_engine,
    _port_engine,
)
from repro.core.md import MDEngine as JaxMDEngine  # noqa: E402
from repro.core.md import make_grappa_like as jax_make_grappa_like  # noqa: E402
from repro.core.md.cells import bin_to_cells as jax_bin_to_cells  # noqa: E402
from repro.core.md.cells import cell_counts as jax_cell_counts  # noqa: E402
from repro.core.md.cells import choose_layout as jax_choose_layout  # noqa: E402
from repro.launch.mesh import make_mesh as jax_make_mesh  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    cells_to_domains,
    domains_to_cells,
    system_from_jax,
)
from repro_torch.core.halo_plan import HaloSpec  # noqa: E402
from repro_torch.core.md import (  # noqa: E402
    MDEngine,
    choose_layout,
    direct_forces_reference,
    make_grappa_like,
)
from repro_torch.core.md.cells import bin_to_cells, cell_counts  # noqa: E402
from repro_torch.core.md.domain import rebin  # noqa: E402
from repro_torch.launch.mesh import make_md_mesh, make_mesh  # noqa: E402
from _torch_threads import share_cores  # noqa: E402


# --------------------------------------------------------------------------
# host geometry: identical
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """Run this module's PyTorch ops on the worker's share of the cores."""
    yield from share_cores()


@pytest.mark.parametrize("n,seed,dtype", [(300, 11, np.float32),
                                          (900, 3, np.float64),
                                          (45_000, 0, np.float32)])
def test_make_grappa_like_identical(n, seed, dtype):
    a = jax_make_grappa_like(n, seed=seed, dtype=dtype)
    b = make_grappa_like(n, seed=seed, dtype=dtype)
    for f in ("box", "pos", "vel", "charge", "typ"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert dataclasses.asdict(a.params) == dataclasses.asdict(b.params)
    c = system_from_jax(a)
    assert c.params == b.params
    for f in ("box", "pos", "vel", "charge", "typ"):
        assert np.array_equal(getattr(c, f), getattr(b, f)), f


@pytest.mark.parametrize("n,mesh", [(300, (1, 1, 1)), (900, (2, 2, 2)),
                                    (45_000, (2, 2, 2)), (2400, (4, 1, 1))])
def test_choose_layout_matches_jax(n, mesh):
    s = make_grappa_like(n, seed=0)
    r_list = s.params.ff.r_cut * 1.08
    want = jax_choose_layout(s.box, mesh, r_list, n)
    got = choose_layout(s.box, mesh, r_list, n)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_grappa_45k_layout_is_the_documented_one():
    s = make_grappa_like(45_000, seed=0)
    lay = choose_layout(s.box, (2, 2, 2), s.params.ff.r_cut * 1.08, 45_000)
    assert lay.cells_per_domain == (7, 7, 7)
    assert lay.global_cells == (14, 14, 14) and lay.capacity == 40


@pytest.mark.parametrize("n,shape", [(1, (1, 1, 1)), (8, (2, 2, 2)),
                                     (16, (4, 2, 2)), (12, (3, 2, 2)),
                                     (256, (8, 8, 4)), (512, (8, 8, 8))])
def test_make_md_mesh_factoring(n, shape):
    mesh = make_md_mesh(n)
    assert mesh.axis_names == AXES and mesh.axis_sizes == shape
    assert mesh.size == n


def test_domain_layout_round_trip():
    rng = np.random.RandomState(0)
    f = rng.randn(4, 6, 2, 3, 5)
    i = rng.randint(0, 9, (4, 6, 2, 3, 2))
    df, di = cells_to_domains(f, i, (2, 3, 1))
    assert df.shape == (2, 3, 1, 2, 2, 2, 3, 5)
    assert np.array_equal(df[1, 2, 0], f[2:4, 4:6, 0:2])
    gf, gi = domains_to_cells(df, di)
    assert np.array_equal(gf, f) and np.array_equal(gi, i)
    tf, _ = cells_to_domains(torch.from_numpy(f), torch.from_numpy(i),
                             (2, 3, 1))
    assert np.array_equal(tf.numpy(), df)


# --------------------------------------------------------------------------
# binning and rebin / migration: bitwise
# --------------------------------------------------------------------------

@pytest.mark.parametrize("safety", [2.2, 0.6])
def test_bin_to_cells_bitwise(safety):
    """Two domains of a (2,1,2) layout, invalid slots, and (at the tight
    safety) overflowing cells."""
    s = make_grappa_like(900, seed=5)
    mesh = (2, 1, 2)
    lay = choose_layout(s.box, mesh, 2.6, 900, safety=safety)
    jlay = jax_choose_layout(s.box, mesh, 2.6, 900, safety=safety)
    rng = np.random.RandomState(1)
    P = 500
    dom = np.array([[1, 0, 1], [0, 0, 1]], np.int32)
    pos = np.stack([rng.uniform(0, 1, (P, 3)) * s.box / 2 + d * s.box / 2
                    for d in dom]).astype(np.float32)
    ff = rng.randn(2, P, 4).astype(np.float32)
    fi = np.stack([rng.permutation(P), rng.randint(0, 2, P)], -1)
    fi = np.stack([fi, fi]).astype(np.int32)
    fi[:, ::7, 0] = -1                       # empty slots
    cf, ci, ovf = bin_to_cells(torch.from_numpy(pos), torch.from_numpy(ff),
                               torch.from_numpy(fi), lay,
                               torch.from_numpy(dom))
    for b in range(2):
        jf, ji, jo = jax_bin_to_cells(jnp.asarray(pos[b]), jnp.asarray(ff[b]),
                                      jnp.asarray(fi[b]), jlay,
                                      jnp.asarray(dom[b]))
        assert np.array_equal(cf[b].numpy(), np.asarray(jf))
        assert np.array_equal(ci[b].numpy(), np.asarray(ji))
        assert int(ovf[b]) == int(jo)
        assert np.array_equal(cell_counts(ci[b]).numpy(),
                              np.asarray(jax_cell_counts(ji)))
    if safety < 1:
        assert int(ovf.sum()) > 0


@pytest.fixture(scope="module")
def f32_system():
    return make_grappa_like(300, seed=11)


@pytest.fixture(scope="module")
def jax_f32_engine(f32_system):
    return _jax_engine(f32_system, backend="serialized")


def test_rebin_bitwise_1x1x1(f32_system, jax_f32_engine):
    """Wrap + re-bin after atoms moved across cells and the box edge."""
    jeng = jax_f32_engine
    cf, ci = (np.array(a) for a in jeng.init_state())
    rng = np.random.RandomState(2)
    valid = ci[..., 0] >= 0
    cf = cf.copy()
    cf[..., :3] += np.where(valid[..., None],
                            rng.uniform(-1.5, 1.5, cf[..., :3].shape),
                            0).astype(np.float32)
    assert (cf[..., :3][valid] < 0).any()
    jf, ji, _force, jdiag = jeng.rebin_fn(jnp.asarray(cf), jnp.asarray(ci))

    eng = _port_engine(f32_system)
    tf, ti = cells_to_domains(torch.from_numpy(cf), torch.from_numpy(ci),
                              (1, 1, 1))
    nf, ni, diag = rebin(tf.contiguous(), ti.contiguous(), eng.layout,
                         eng.mig_cap)
    gf, gi = domains_to_cells(nf, ni)
    assert np.array_equal(gf.numpy(), np.asarray(jf))
    assert np.array_equal(gi.numpy(), np.asarray(ji))
    assert _diag_rows([diag]) == _diag_rows([jdiag])


def test_migration_on_3x2x2_routes_every_atom_home():
    """S = 3 exercises both neighbour directions (and so the roll signs)."""
    s = make_grappa_like(1600, seed=4)
    eng = _port_engine(s, mesh_shape=(3, 2, 2), backend="serialized")
    assert eng.layout.mesh_shape == (3, 2, 2)
    cf, ci = eng.init_state()
    rng = np.random.RandomState(3)
    valid = (ci[..., 0] >= 0).numpy()
    disp = np.where(valid[..., None], rng.uniform(-0.9, 0.9,
                                                  tuple(cf.shape[:-1]) + (3,)),
                    0.0).astype(np.float32)
    cf = cf.clone()
    cf[..., :3] += torch.from_numpy(disp)
    nf, ni, diag = rebin(cf, ci, eng.layout, eng.mig_cap)
    assert {k: int(v) for k, v in diag.items()} == {
        "migration_dropped": 0, "migration_lost": 0, "bin_overflow": 0,
        "n_atoms": 1600}
    ids = ni[..., 0].reshape(-1)
    assert torch.equal(torch.sort(ids[ids >= 0]).values, torch.arange(1600))
    # every atom sits in the domain and cell its position says
    csz = torch.tensor(eng.layout.cell_size)
    lay = eng.layout
    for dom in np.ndindex(*lay.mesh_shape):
        m = ni[dom][..., 0] >= 0
        cell = torch.floor(nf[dom][..., :3] / csz).long()
        home = torch.stack(torch.meshgrid(
            *[torch.arange(c) + dom[d] * c for d, c in
              enumerate(lay.cells_per_domain)], indexing="ij"), -1)
        home = home[:, :, :, None, :].expand_as(cell)
        assert torch.equal(cell[m], home[m]), dom
    # positions moved by the displacement, modulo the box
    pos, = eng.gather_by_id([nf[..., :3]], ni)
    p0, = eng.gather_by_id([cf[..., :3]], ci)
    assert np.allclose(pos, np.mod(p0, s.box), atol=1e-5)


# --------------------------------------------------------------------------
# forces (f32) and whole-slice trajectories (f64)
# --------------------------------------------------------------------------

def test_forces_f32_match_jax_and_oracle(f32_system, jax_f32_engine):
    jeng = jax_f32_engine
    jf, ji, _f, _d = jeng.rebin_fn(*jeng.init_state())
    jforce, jpe = jeng.force_fn(jf, ji)
    f_jax, = jeng.gather_by_id([jforce], ji)

    eng = _port_engine(f32_system)
    tf, ti = cells_to_domains(torch.from_numpy(np.array(jf)),
                              torch.from_numpy(np.array(ji)), (1, 1, 1))
    force, pe = eng.force_fn(tf.contiguous(), ti.contiguous())
    f_port, = eng.gather_by_id([force], ti)
    assert force.dtype == torch.float32 and pe.dtype == torch.float32

    scale = np.abs(f_jax).max()
    assert np.abs(f_port - f_jax).max() / scale < 1e-5
    assert abs(float(pe) - float(jpe)) / abs(float(jpe)) < 1e-5
    f_ref, _ = direct_forces_reference(
        f32_system.pos, f32_system.charge, f32_system.typ, f32_system.box,
        f32_system.params.ff)
    assert np.abs(f_port - f_ref).max() / np.abs(f_ref).max() < 5e-5
    assert np.abs(f_port.sum(axis=0)).max() < 1e-3       # Newton's third law



def test_short_nve_run_is_stable(f32_system):
    """The reference's own bar (tests/test_md.py) on the port."""
    _, m, diags = _port_engine(f32_system).simulate(40)
    E = m["pe"] + m["ke"]
    assert np.all(np.isfinite(E))
    assert (E.max() - E.min()) / f32_system.n_atoms < 5e-3
    assert np.abs(m["mom"]).max() < 1e-3
    for dg in diags:
        assert dg["n_atoms"] == f32_system.n_atoms


def _wire_spec(wire_dtype):
    return dict(spec=HaloSpec(AXES, (1, 1, 1), wire_dtype=wire_dtype))


@pytest.mark.parametrize("kw,match", [
    # static_ladder, health and obs are ported (the serving slice): their
    # cases pin the guards that remain, the reference's static_ladder +
    # nstprune refusal beside them
    pytest.param(dict(force_backend="pallas", static_ladder=True,
                      nstprune=2), "nstprune", id="kw2-static_ladder"),
    # wire compression is ported: through spec= and through the knob, the
    # drift gate rejects "int8" and an unknown name raises, as in JAX
    pytest.param(_wire_spec, "wire", id="kw3-wire"),
    pytest.param(lambda wd: dict(wire_dtype=wd), "wire", id="kw5-wire"),
    # trace and inject are ported (the resilience slice): they build and
    # leave a run's bits alone (match None), and the reference's one
    # refusal that remains, inject with overlap_rebin, raises as there
    pytest.param(dict(trace=True), None, id="kw6-trace"),
    pytest.param(dict(inject=True), None, id="kw7-inject"),
    pytest.param(dict(health=True, inject=True, overlap_rebin=True),
                 "overlap_rebin", id="kw8-health"),
    pytest.param(dict(obs=True, trace=True), None, id="kw9-obs"),
])
def test_unported_engine_knobs_raise(f32_system, kw, match):
    mesh = make_mesh((1, 1, 1), AXES)
    if callable(kw):
        from repro_torch.core.wire import WireDriftError
        with pytest.raises(WireDriftError, match="exceeds the dense-f32"):
            MDEngine(f32_system, mesh, device="cpu", **kw("int8"))
        with pytest.raises(ValueError, match="unknown wire_dtype"):
            MDEngine(f32_system, mesh, device="cpu", **kw("nope"))
        return
    if kw.get("obs") is True:
        from repro_torch.obs import MetricsRegistry
        kw = dict(kw, obs=MetricsRegistry())
    if match is None:
        runs = [MDEngine(f32_system, mesh, device="cpu", **k).simulate(2)
                for k in (kw, {})]
        assert torch.equal(runs[0][0][0], runs[1][0][0])
        for k in ("pe", "ke", "mom"):
            assert np.array_equal(runs[0][1][k], runs[1][1][k]), k
        assert ("obs/released" in runs[0][1]) == bool(kw.get("trace"))
        return
    with pytest.raises(ValueError, match=match):
        MDEngine(f32_system, mesh, device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    pytest.param(dict(pipeline="double_buffer"), id="pipeline"),
    pytest.param(dict(overlap_rebin=True), id="overlap_rebin"),
    pytest.param(dict(spec=HaloSpec(AXES, (1, 1, 1), backend="signal")),
                 id="signal"),
])
def test_ported_engine_knobs_build(f32_system, kw):
    """The knobs this slice ports build and run (two steps), and the run
    equals the default engine's bitwise; the signal backend's equals the
    serialized one's (the fused default returns forces summed in another
    association, so its last bits differ from both: equal metrics
    against it were luck)."""
    ref = {"spec": HaloSpec(AXES, (1, 1, 1), backend="serialized")} \
        if "spec" in kw else {}
    runs = [MDEngine(f32_system, make_mesh((1, 1, 1), AXES), device="cpu",
                     **k).simulate(2) for k in (kw, ref)]
    assert torch.equal(runs[0][0][0], runs[1][0][0])
    for k in ("pe", "ke", "mom"):
        assert runs[0][1][k].shape[0] == 2
        assert np.array_equal(runs[0][1][k], runs[1][1][k]), k


def test_engine_gate_matches_jax(f32_system):
    """``pipeline_depth`` and the build-time verifier gate: the configs
    the reference rejects raise the same error class and message."""
    mesh, jmesh = make_mesh((1, 1, 1), AXES), jax_make_mesh((1, 1, 1), AXES)
    for kw in (dict(force_backend="sparse", nstprune=25),
               dict(force_backend="sparse", nstprune=4, r_list_factor=0.5),
               dict(pipeline="double_buffer", pipeline_depth=1),
               dict(verify="loud")):
        with pytest.raises(ValueError) as want:
            JaxMDEngine(f32_system, jmesh, **kw)
        with pytest.raises(ValueError) as got:
            MDEngine(f32_system, mesh, device="cpu", **kw)
        assert (type(got.value).__name__, str(got.value)) == \
            (type(want.value).__name__, str(want.value))
    eng = MDEngine(f32_system, mesh, device="cpu", pipeline="double_buffer",
                   pipeline_depth=4, overlap_rebin=True)
    jeng = JaxMDEngine(f32_system, jmesh, pipeline="double_buffer",
                       pipeline_depth=4, overlap_rebin=True)
    assert eng.schedule_report.to_dict() == jeng.schedule_report.to_dict()
    assert eng.halo_stats() == jeng.halo_stats()
    assert eng.overlap_stats() == jeng.overlap_stats()
    with pytest.warns(RuntimeWarning, match="rejected by the static"):
        eng = MDEngine(f32_system, mesh, device="cpu",
                       force_backend="sparse", nstprune=25, verify="warn")
    assert eng.schedule_report is None
