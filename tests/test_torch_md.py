"""The port's MD slice against the JAX MDEngine.

Bitwise where the work is data movement (system builder, binning,
rebin / migration), to stated tolerances where it is arithmetic:
* f32 forces: 1e-5 of the force scale against JAX (summation order
  differs), 5e-5 against the O(N^2) direct oracle; PE to 1e-5 relative;
* 24-step f64 trajectories: per-step PE / KE to 1e-9 relative and final
  positions to 1e-9 of the box, on 1x1x1 in process and on a 2x2x2 mesh
  against an 8-virtual-device JAX run in a subprocess.
Within the port the pallas and serialized halo backends must give
bitwise-identical trajectories on 2x2x2.
"""
import contextlib
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the JAX package is the reference

import jax.numpy as jnp  # noqa: E402

from repro.core.halo_plan import HaloSpec as JaxHaloSpec
from repro.core.md import MDEngine as JaxMDEngine
from repro.core.md import make_grappa_like as jax_make_grappa_like
from repro.core.md.cells import bin_to_cells as jax_bin_to_cells
from repro.core.md.cells import cell_counts as jax_cell_counts
from repro.core.md.cells import choose_layout as jax_choose_layout
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro_torch.convert import (
    cells_to_domains,
    domains_to_cells,
    system_from_jax,
)
from repro_torch.core.halo_plan import HaloSpec
from repro_torch.core.md import (
    MDEngine,
    choose_layout,
    direct_forces_reference,
    make_grappa_like,
)
from repro_torch.core.md.cells import bin_to_cells, cell_counts
from repro_torch.core.md.domain import rebin
from repro_torch.launch.mesh import make_md_mesh, make_mesh

AXES = ("z", "y", "x")
REPO = Path(__file__).resolve().parent.parent
DIAG_KEYS = ("migration_dropped", "migration_lost", "bin_overflow",
             "n_atoms")


@contextlib.contextmanager
def x64(enabled: bool):
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", enabled)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _port_engine(system, mesh_shape=(1, 1, 1), backend="pallas"):
    return MDEngine(system, make_mesh(mesh_shape, AXES),
                    HaloSpec(AXES, (1, 1, 1), backend=backend),
                    device="cpu")


def _jax_engine(system, backend="pallas"):
    return JaxMDEngine(system, jax_make_mesh((1, 1, 1), AXES),
                       JaxHaloSpec(AXES, (1, 1, 1), backend=backend))


def _diag_rows(diags):
    return [[int(np.asarray(d[k])) for k in DIAG_KEYS] for d in diags]


# --------------------------------------------------------------------------
# host geometry: identical
# --------------------------------------------------------------------------

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


def _assert_trajectories_agree(m, d, pos, ref_m, ref_d, ref_pos, box):
    for k in ("pe", "ke"):
        rel = np.abs(m[k] - ref_m[k]).max() / np.abs(ref_m[k]).max()
        assert rel < 1e-9, (k, rel)
    assert np.abs(pos - ref_pos).max() / box < 1e-9
    assert _diag_rows(d) == _diag_rows(ref_d)


def test_whole_slice_f64_1x1x1_matches_jax():
    with x64(True):
        s = jax_make_grappa_like(300, seed=11, dtype=np.float64)
        jeng = _jax_engine(s, backend="pallas")
        (jcf, jci), jm, jd = jeng.simulate(24)
        jpos, = jeng.gather_by_id([jcf[..., :3]], jci)
        jstats = jeng.halo_stats()
        assert jeng.plan._pallas_broken is False
    eng = _port_engine(system_from_jax(s))
    (cf, ci), m, d = eng.simulate(24)
    pos, = eng.gather_by_id([cf[..., :3]], ci)
    assert m["pe"].shape == (24,) and m["mom"].shape == (24, 3)
    assert cf.dtype == torch.float64
    _assert_trajectories_agree(m, d, pos, jm, jd, jpos, s.box[0])
    assert len(d) == 2                       # crossed one rebin
    assert eng.halo_stats() == jstats
    assert eng.overlap_stats() == jeng.overlap_stats()
    assert eng.pair_stats() == jeng.pair_stats()


# the 2x2x2 reference: one JAX run on 8 virtual devices, in a subprocess
# (the main pytest process keeps a single JAX device)
_JAX_DD_SCRIPT = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
from repro.core.halo_plan import HaloSpec
from repro.core.md import MDEngine, make_grappa_like
from repro.launch.mesh import make_mesh
assert len(jax.devices()) >= 8
s = make_grappa_like(900, seed=3, dtype=np.float64)
keys = ("migration_dropped", "migration_lost", "bin_overflow", "n_atoms")
out = {}
# the dense run, then the pruned "sparse" backend with nstprune 0 and 4
for tag, kw in (("", {}), ("sparse0_", dict(force_backend="sparse")),
                ("sparse4_", dict(force_backend="sparse", nstprune=4))):
    eng = MDEngine(s, make_mesh((2, 2, 2), ("z", "y", "x")),
                   HaloSpec(("z", "y", "x"), (1, 1, 1), backend="pallas"),
                   **kw)
    (cf, ci), m, d = eng.simulate(24)
    pos, = eng.gather_by_id([cf[..., :3]], ci)
    out.update({tag + "pe": m["pe"], tag + "ke": m["ke"],
                tag + "mom": m["mom"], tag + "pos": pos,
                tag + "diags": np.array([[int(x[k]) for k in keys]
                                         for x in d]),
                tag + "sched_history": np.array(eng.sched_history)})
np.savez(sys.argv[1], pallas_broken=eng.plan._pallas_broken, **out)
"""


@pytest.fixture(scope="session")
def jax_dd_reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_dd") / "ref_2x2x2.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = f"{REPO / 'src'}:{env.get('PYTHONPATH', '')}"
    proc = subprocess.run([sys.executable, "-c", _JAX_DD_SCRIPT, str(out)],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    if proc.returncode != 0:
        raise AssertionError(f"JAX 2x2x2 reference failed:\n{proc.stderr}")
    return dict(np.load(out))


@pytest.fixture(scope="module")
def port_dd_f64():
    s = make_grappa_like(900, seed=3, dtype=np.float64)
    eng = _port_engine(s, mesh_shape=(2, 2, 2))
    (cf, ci), m, d = eng.simulate(24)
    pos, = eng.gather_by_id([cf[..., :3]], ci)
    return s, m, d, pos


def test_whole_slice_f64_2x2x2_matches_jax(jax_dd_reference, port_dd_f64):
    ref = jax_dd_reference
    assert not bool(ref["pallas_broken"])
    s, m, d, pos = port_dd_f64
    ref_d = [dict(zip(DIAG_KEYS, row)) for row in ref["diags"]]
    _assert_trajectories_agree(m, d, pos, ref, ref_d, ref["pos"], s.box[0])
    assert np.abs(m["mom"] - ref["mom"]).max() < 1e-9


@pytest.mark.parametrize("nstprune", [0, 4])
def test_pruned_f64_2x2x2_matches_jax_sparse(jax_dd_reference, nstprune):
    """The port's ``"pallas"`` force backend (its kernels' plain forms on
    the CPU) against JAX's ``"sparse"`` backend on 8 devices."""
    ref = {k[len(f"sparse{nstprune}_"):]: v
           for k, v in jax_dd_reference.items()
           if k.startswith(f"sparse{nstprune}_")}
    s = make_grappa_like(900, seed=3, dtype=np.float64)
    eng = MDEngine(s, make_mesh((2, 2, 2), AXES),
                   HaloSpec(AXES, (1, 1, 1), backend="pallas"),
                   force_backend="pallas", nstprune=nstprune, device="cpu")
    (cf, ci), m, d = eng.simulate(24)
    pos, = eng.gather_by_id([cf[..., :3]], ci)
    ref_d = [dict(zip(DIAG_KEYS, row)) for row in ref["diags"]]
    _assert_trajectories_agree(m, d, pos, ref, ref_d, ref["pos"], s.box[0])
    assert np.abs(m["mom"] - ref["mom"]).max() < 1e-9
    assert eng.sched_history == [tuple(r) for r in ref["sched_history"]]


def test_pallas_equals_serialized_bitwise_2x2x2():
    s = make_grappa_like(900, seed=3)
    runs = {}
    for b in ("pallas", "serialized"):
        eng = _port_engine(s, mesh_shape=(2, 2, 2), backend=b)
        (cf, ci), m, d = eng.simulate(24)
        runs[b] = (cf, ci, m, d)
    p, q = runs["pallas"], runs["serialized"]
    assert torch.equal(p[0], q[0]) and torch.equal(p[1], q[1])
    for k in ("pe", "ke", "mom"):
        assert np.array_equal(p[2][k], q[2][k]), k
    assert p[3] == q[3]
    E = p[2]["pe"] + p[2]["ke"]
    assert np.all(np.isfinite(E))
    assert (E.max() - E.min()) / s.n_atoms < 5e-3


def test_short_nve_run_is_stable(f32_system):
    """The reference's own bar (tests/test_md.py) on the port."""
    _, m, diags = _port_engine(f32_system).simulate(40)
    E = m["pe"] + m["ke"]
    assert np.all(np.isfinite(E))
    assert (E.max() - E.min()) / f32_system.n_atoms < 5e-3
    assert np.abs(m["mom"]).max() < 1e-3
    for dg in diags:
        assert dg["n_atoms"] == f32_system.n_atoms


@pytest.mark.parametrize("kw,match", [
    (dict(pipeline="double_buffer"), "pipeline"),
    (dict(overlap_rebin=True), "overlap_rebin"),
    (dict(force_backend="pallas", static_ladder=True), "static_ladder"),
    (dict(spec=HaloSpec(AXES, (1, 1, 1), wire_dtype="bfloat16")), "wire"),
    (dict(spec=HaloSpec(AXES, (1, 1, 1), backend="signal")), "signal"),
    (dict(wire_dtype="bfloat16"), "wire"),
    (dict(trace=True), "trace"),
    (dict(inject=True), "inject"),
    (dict(health=True), "health"),
    (dict(obs=object()), "obs"),
])
def test_unported_engine_knobs_raise(f32_system, kw, match):
    with pytest.raises(NotImplementedError, match=match):
        MDEngine(f32_system, make_mesh((1, 1, 1), AXES), device="cpu", **kw)
