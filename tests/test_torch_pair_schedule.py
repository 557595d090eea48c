"""The port's pruned pair schedule against the JAX package.

Bitwise where the work is integer bookkeeping or an ordered sum: the
schedule planner (``schedule_opt``), cell levels and bounding boxes, the
worklist, the outer and rolling prunes (``sel``, ``cum``, ``cum_inner``,
``occ``, per domain on 1x1x1 and 3x2x2 meshes) and ``scatter_accum``.
To stated tolerances where it is arithmetic:
* ``pair_forces`` (plain form) against the JAX kernel in interpret mode
  and the float64 loop oracle: 5e-6 of the force scale in f32 (the
  reference's own ``FORCE_RTOL``), 1e-12 in f64; PE likewise relative;
* 24-step f64 trajectories of ``force_backend="pallas"`` with
  ``nstprune`` 0 and 4 against the JAX engine on 1x1x1: PE / KE to 1e-9
  relative, positions to 1e-9 of the box (the 2x2x2 comparison against
  JAX's ``"sparse"`` backend lives in ``test_torch_md.py``, beside the
  8-device harness it shares).
"""
import contextlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the JAX package is the reference

import jax.numpy as jnp  # noqa: E402

from repro.core.halo_plan import HaloSpec as JaxHaloSpec
from repro.core.md import MDEngine as JaxMDEngine
from repro.core.md import make_grappa_like as jax_make_grappa_like
from repro.core.md import pair_schedule as jps
from repro.core.md import schedule_opt as jso
from repro.core.md.cells import cell_bounds as jax_cell_bounds
from repro.core.md.cells import cell_levels as jax_cell_levels
from repro.core.md.cells import choose_layout as jax_choose_layout
from repro.kernels import nonbonded as jnb
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro_torch.convert import system_from_jax
from repro_torch.core.halo_plan import HaloSpec
from repro_torch.core.md import (
    DEFAULT_FF,
    MDEngine,
    choose_layout,
    force_backends,
    make_grappa_like,
)
from repro_torch.core.md import pair_schedule as ps
from repro_torch.core.md import schedule_opt as so
from repro_torch.core.md.cells import cell_bounds, cell_levels
from repro_torch.kernels import nonbonded, ref
from repro_torch.launch.mesh import make_mesh

AXES = ("z", "y", "x")
FORCE_RTOL = {np.float32: 5e-6, np.float64: 1e-12}
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


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


# --------------------------------------------------------------------------
# the schedule planner, levels, bounds, worklist: identical
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_schedule_opt_matches_reference(seed):
    rng = np.random.RandomState(seed)
    L = int(rng.randint(1, 12))
    cap_pairs = int(rng.randint(50, 5000))
    hist = rng.randint(0, cap_pairs // L + 1, size=L)
    cum = [int(v) for v in np.cumsum(hist[::-1])[::-1]]
    quantum, capacity = 4, 4 * L - int(rng.randint(0, 4))
    pair_bucket = int(rng.choice([1, 16, 64, 100]))
    for n in [0, 1, 63, 64, 65, cap_pairs, cap_pairs + 7]:
        assert so.bucket(n, pair_bucket, cap_pairs) == \
            jso.bucket(n, pair_bucket, cap_pairs)
        assert so.bucket0(n, pair_bucket, cap_pairs) == \
            jso.bucket0(n, pair_bucket, cap_pairs)
    tiers = so.tier_plan(cum, pair_bucket, cap_pairs, quantum, capacity)
    assert tiers == jso.tier_plan(cum, pair_bucket, cap_pairs, quantum,
                                  capacity)
    assert so.tier_rows(tiers) == jso.tier_rows(tiers)
    assert so.tier_slot_pairs(tiers) == jso.tier_slot_pairs(tiers)
    assert so.tier_cum(tiers, quantum, L) == jso.tier_cum(tiers, quantum, L)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cell_levels_and_bounds_match_jax(dtype):
    rng = np.random.RandomState(4)
    ids = rng.randint(-1, 50, size=(3, 4, 5, 9)).astype(np.int32)
    ids[0, 0, 0] = -1                                   # an empty cell
    cell_i = np.stack([ids, np.zeros_like(ids)], -1)
    pos = rng.uniform(-3, 3, size=(3, 4, 5, 9, 3)).astype(dtype)
    counts = np.sum(ids >= 0, axis=-1).astype(np.int32)
    assert np.array_equal(_np(cell_levels(torch.from_numpy(counts), 4)),
                          np.asarray(jax_cell_levels(jnp.asarray(counts), 4)))
    with x64(dtype == np.float64):
        want = jax_cell_bounds(jnp.asarray(pos), jnp.asarray(cell_i))
        got = cell_bounds(torch.from_numpy(pos), torch.from_numpy(cell_i))
        for g, w in zip(got, want):
            assert g.numpy().tobytes() == np.asarray(w).tobytes()
    big = torch.tensor(1e30, dtype=got[0].dtype)
    assert torch.all(got[0][0, 0, 0] == big)            # empty: (+big, -big)
    assert torch.all(got[1][0, 0, 0] == -big)


@pytest.mark.parametrize("n,mesh", [(300, (1, 1, 1)), (900, (2, 2, 2)),
                                    (1600, (3, 2, 2))])
def test_worklist_and_radii_match_jax(n, mesh):
    s = make_grappa_like(n, seed=0)
    r_list = s.params.ff.r_cut * 1.08
    sched = ps.PairSchedule.build(choose_layout(s.box, mesh, r_list, n))
    jsched = jps.PairSchedule.build(jax_choose_layout(s.box, mesh, r_list,
                                                      n))
    for f in ("cell_a", "cell_b", "same"):
        assert np.array_equal(getattr(sched, f), getattr(jsched, f)), f
    assert (sched.n_pairs, sched.n_ext_cells, sched.levels) == \
        (jsched.n_pairs, jsched.n_ext_cells, jsched.levels)
    assert sched.slot_pair_stats() == jsched.slot_pair_stats()
    tiers = ((64, 12), (128, 8))
    assert sched.slot_pair_stats(tiers, tiers[1:], 150, 120, 11, 9999) == \
        jsched.slot_pair_stats(tiers, tiers[1:], 150, 120, 11, 9999)
    js = jax_make_grappa_like(n, seed=0)
    assert ps.prune_radius(s.params) == jps.prune_radius(js.params)
    for k in (1, 4, 5):
        assert ps.inner_radius(s.params, k) == jps.inner_radius(js.params, k)


# --------------------------------------------------------------------------
# the outer and rolling prunes: bitwise, every domain
# --------------------------------------------------------------------------

def _shrunk_state(eng, gap=1.85):
    """The engine's binned state with every atom pulled toward its cell's
    centre until neighbouring cells' boxes sit ``gap`` apart per dim: face
    pairs survive both prunes, edge pairs (gap^2 = 6.8) only the outer one
    (r_prune^2 = 7.5, r_inner^2 = 6.5 at nstprune=4), corner pairs none."""
    cf, ci = eng.init_state()
    csz = torch.tensor(eng.layout.cell_size, dtype=torch.float64)
    pos = cf[..., :3].double()
    lo, hi = cell_bounds(pos, ci)
    mid, half = (lo + hi)[..., None, :] / 2, (hi - lo)[..., None, :] / 2
    centre = (torch.floor(mid / csz) + 0.5) * csz
    new = centre + (pos - mid) / torch.clamp(half, min=1e-9) * \
        ((csz - gap) / 2)
    cf = cf.clone()
    valid = (ci[..., 0] >= 0)[..., None]
    cf[..., :3] = torch.where(valid, new.to(cf.dtype), cf[..., :3])
    return cf, ci


def _trimmed_ext(eng, cf, ci):
    return (eng._trim_ext(eng.plan.fwd(cf[..., :4].contiguous())),
            eng._trim_ext(eng.plan.fwd(ci, wrap_shift=None)))


@pytest.mark.parametrize("mesh,n", [((1, 1, 1), 300), ((3, 2, 2), 1600)])
def test_prunes_match_jax_per_domain(mesh, n):
    s = make_grappa_like(n, seed=2)
    eng = MDEngine(s, make_mesh(mesh, AXES),
                   HaloSpec(AXES, (1, 1, 1), backend="serialized"),
                   force_backend="sparse", nstprune=4, device="cpu")
    sched, jsched = eng.pair_schedule, jps.PairSchedule.build(
        jax_choose_layout(s.box, mesh, s.params.ff.r_cut * 1.08, n))
    cf, ci = _shrunk_state(eng)
    ext_f, ext_i = _trimmed_ext(eng, cf, ci)
    sel, cum, cum_in, occ = ps.prune_local(sched, ext_f, ext_i, eng.r_prune,
                                           r_inner=eng.r_inner)
    M = sched.n_pairs
    assert int(cum[..., 0].max()) < M           # the outer prune dropped
    # a drift, then the rolling prune of the packed outer prefix
    rng = np.random.RandomState(5)
    cf2 = cf.clone()
    cf2[..., :3] += torch.from_numpy(rng.uniform(
        -0.02, 0.02, tuple(cf.shape[:-1]) + (3,)).astype(np.float32))
    ext_f2, _ = _trimmed_ext(eng, cf2, ci)
    n_exec = int(cum[..., 0].max())
    sel_r, cum_r = ps.roll_prune(sched, sel[..., :n_exec], ext_f2, ext_i,
                                 eng.r_inner)
    assert int(cum_r[..., 0].max()) < n_exec    # and the rolling prune too
    for dom in np.ndindex(*mesh):
        jsel, jcum, jcum_in, jocc = jps.prune_local(
            jsched, jnp.asarray(_np(ext_f[dom])), jnp.asarray(_np(ext_i[dom])),
            eng.r_prune, r_inner=eng.r_inner)
        assert np.array_equal(_np(sel[dom]), np.asarray(jsel)), dom
        assert np.array_equal(_np(cum[dom]), np.asarray(jcum)), dom
        assert np.array_equal(_np(cum_in[dom]), np.asarray(jcum_in)), dom
        assert int(occ[dom]) == int(jocc), dom
        jsel_r, jcum_r = jps.roll_prune(
            jsched, jsel[:n_exec], jnp.asarray(_np(ext_f2[dom])),
            jnp.asarray(_np(ext_i[dom])), eng.r_inner)
        assert np.array_equal(_np(sel_r[dom]), np.asarray(jsel_r)), dom
        assert np.array_equal(_np(cum_r[dom]), np.asarray(jcum_r)), dom
    # the engine's mesh-global histograms are the max over domains
    _sel, gcum, gcum_in, gocc = eng.do_prune(cf, ci)
    assert torch.equal(gcum, torch.amax(cum, dim=(0, 1, 2)))
    assert torch.equal(gcum_in, torch.amax(cum_in, dim=(0, 1, 2)))
    assert int(gocc) == int(occ.max())


# --------------------------------------------------------------------------
# the kernels' plain forms against the JAX kernels and the f64 oracle
# --------------------------------------------------------------------------

def _pair_batch(dtype, seed=0, N=7, K=8):
    """N cell pairs on jittered lattices (no two atoms closer than ~0.7,
    some pairs beyond the cutoff): random fills, a full pair, a self pair,
    an empty pair and a sentinel-like all-zero pair.  Empty slots carry
    type -1, so both validity modes see the same atoms."""
    rng = np.random.RandomState(seed)
    site = np.stack(np.meshgrid(*[np.arange(2)] * 3, indexing="ij"),
                    -1).reshape(8, 3)[:K]

    def cells(shift):
        pos = site[None] + shift + rng.uniform(-0.1, 0.1, (N, K, 3))
        q = rng.uniform(-0.5, 0.5, (N, K, 1))
        return np.concatenate([pos, q], -1).astype(dtype)

    a = cells(np.zeros(3))
    b = cells(np.array([1.6, 0.5, 0.5]))
    cnt_a = rng.randint(0, K + 1, N).astype(np.int32)
    cnt_b = rng.randint(0, K + 1, N).astype(np.int32)
    same = np.zeros(N, np.int32)
    cnt_a[0] = cnt_b[0] = K                           # a full pair
    same[1] = 1
    b[1], cnt_b[1] = a[1], cnt_a[1]                   # a cell with itself
    cnt_a[2] = cnt_b[2] = 0                           # an empty pair
    a[3] = b[3] = 0
    cnt_a[3] = cnt_b[3] = 0                           # the sentinel
    slots = np.arange(K)[None, :]
    ta = np.where(slots < cnt_a[:, None], rng.randint(0, 2, (N, K)), -1)
    tb = np.where(slots < cnt_b[:, None], rng.randint(0, 2, (N, K)), -1)
    tb[1] = ta[1]
    return dict(a=a, b=b, ta=ta.astype(np.int32), tb=tb.astype(np.int32),
                same=same, cnt_a=cnt_a, cnt_b=cnt_b)


def _args(batch, mode, to=np.asarray):
    """Positional arrays and count keywords for ``mode`` "counts" (the
    per-pair counts mask the slots) or "types" (type >= 0 does)."""
    args = [to(batch[k]) for k in ("a", "b", "ta", "tb", "same")]
    kw = {} if mode == "types" else {k: to(batch[k])
                                     for k in ("cnt_a", "cnt_b")}
    return args, kw


@pytest.mark.parametrize("mode", ["counts", "types"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pair_forces_plain_matches_jax_kernel_and_oracle(dtype, mode):
    batch = _pair_batch(dtype)
    args, kw = _args(batch, mode, torch.from_numpy)
    fa, fb, pe = nonbonded.pair_forces(*args, DEFAULT_FF, **kw)
    assert fa.dtype == args[0].dtype and pe.shape == (args[0].shape[0],)
    with x64(dtype == np.float64):
        jargs, jkw = _args(batch, mode, jnp.asarray)
        jfa, jfb, jpe = (np.asarray(x) for x in jnb.pair_forces(
            *jargs, DEFAULT_FF, interpret=True, **jkw))
    ofa, ofb, ope = (x.numpy() for x in ref.pair_forces_ref(
        *args, DEFAULT_FF, **kw))
    tol = FORCE_RTOL[dtype]
    scale = max(np.abs(ofa).max(), np.abs(ofb).max())
    assert scale > 0 and np.abs(ope).max() > 0
    for want in ((jfa, jfb, jpe), (ofa, ofb, ope)):
        assert np.abs(fa.numpy() - want[0]).max() / scale < tol
        assert np.abs(fb.numpy() - want[1]).max() / scale < tol
        assert np.abs(pe.numpy() - want[2]).max() / \
            np.abs(ope).max() < tol
    # masked work is exactly zero: empty and sentinel pairs, empty slots
    for n in (2, 3):
        assert not fa[n].any() and not fb[n].any() and pe[n] == 0
    slots = torch.arange(fa.shape[1])[None, :]
    assert not fa[slots >= torch.from_numpy(batch["cnt_a"])[:, None]].any()
    assert not fb[slots >= torch.from_numpy(batch["cnt_b"])[:, None]].any()
    # Newton's third law on the self pair: its two sides cancel
    assert np.abs((fa[1] + fb[1]).sum(0).numpy()).max() / scale < tol


def _scatter_case(dtype, seed=0, N=40, K=8, n_cells=9):
    rng = np.random.RandomState(seed)
    ca = rng.randint(0, n_cells, N).astype(np.int32)
    cb = rng.randint(0, n_cells, N).astype(np.int32)
    cb[::5] = ca[::5]                     # a cell on both sides of a row
    fa = rng.randn(N, K, 3).astype(dtype)
    fb = rng.randn(N, K, 3).astype(dtype)
    return ca, cb, fa, fb, n_cells


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_scatter_accum_plain_matches_jax_bitwise(dtype):
    ca, cb, fa, fb, n_cells = _scatter_case(dtype)
    with x64(dtype == np.float64):
        want = np.asarray(jnb.scatter_accum(
            jnp.asarray(ca), jnp.asarray(cb), jnp.asarray(fa),
            jnp.asarray(fb), n_cells, interpret=True))
    args = [torch.from_numpy(x) for x in (ca, cb, fa, fb)]
    for got in (nonbonded.scatter_accum(*args, n_cells),
                nonbonded.scatter_accum_plain(
                    *args, n_cells,
                    index=nonbonded.scatter_index(args[0], args[1],
                                                  n_cells))):
        assert got.numpy().tobytes() == want.tobytes()


def test_pair_forces_accum_is_pair_forces_then_scatter():
    args, kw = _args(_pair_batch(np.float32), "counts", torch.from_numpy)
    N = args[0].shape[0]
    ca = torch.arange(N, dtype=torch.int32) % 3
    cb = (torch.arange(N, dtype=torch.int32) + 1) % 3
    F, pe = nonbonded.pair_forces_accum(*args, ca, cb, DEFAULT_FF, 3, **kw)
    fa, fb, pe2 = nonbonded.pair_forces(*args, DEFAULT_FF, **kw)
    assert torch.equal(F, nonbonded.scatter_accum(ca, cb, fa, fb, 3))
    assert torch.equal(pe, pe2)


def test_nonbonded_wrappers_validate_inputs():
    (a, b, ta, tb, same), kw = _args(_pair_batch(np.float32), "counts",
                                     torch.from_numpy)
    cnt_a = kw["cnt_a"]
    with pytest.raises(TypeError, match="int32"):
        nonbonded.pair_forces(a, b, ta.long(), tb, same, DEFAULT_FF)
    with pytest.raises(ValueError, match="both"):
        nonbonded.pair_forces(a, b, ta, tb, same, DEFAULT_FF, cnt_a=cnt_a)
    with pytest.raises(TypeError, match="float32 or float64"):
        nonbonded.pair_forces(a.half(), b.half(), ta, tb, same, DEFAULT_FF)
    fa = torch.zeros((4, 2, 3))
    ids = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    with pytest.raises(IndexError, match="cell index"):
        nonbonded.scatter_accum(ids, ids, fa, fa, 3)
    with pytest.raises(ValueError, match="rows"):
        nonbonded.scatter_accum(ids[:3], ids, fa, fa, 4)


def test_cpu_path_launches_no_kernel():
    before = (nonbonded.pair_forces.launches, nonbonded.scatter_accum.launches)
    args, kw = _args(_pair_batch(np.float64), "counts", torch.from_numpy)
    ids = torch.zeros(args[0].shape[0], dtype=torch.int32)
    nonbonded.pair_forces_accum(*args, ids, ids, DEFAULT_FF, 1, **kw)
    assert (nonbonded.pair_forces.launches,
            nonbonded.scatter_accum.launches) == before


# --------------------------------------------------------------------------
# the engine: pruned backends against the dense pass and against JAX
# --------------------------------------------------------------------------

def test_pruned_force_pass_matches_dense_f32():
    s = make_grappa_like(900, seed=3)
    eng = MDEngine(s, make_mesh((2, 2, 2), AXES),
                   HaloSpec(AXES, (1, 1, 1), backend="pallas"),
                   force_backend="pallas", device="cpu")
    rs = eng.begin_run()
    f_sched, pe_sched = eng.force_fn(rs.cell_f, rs.cell_i)
    f_dense, pe_dense = eng._force_pass(rs.cell_f, rs.cell_i)
    scale = float(f_dense.abs().max())
    assert float((f_sched - f_dense).abs().max()) / scale < 5e-6
    assert abs(float(pe_sched - pe_dense)) / abs(float(pe_dense)) < 5e-6
    # the rebin's force carry is the dense pass, whatever the backend
    eng._force_pass_sched = None
    eng.rebin_fn(rs.cell_f, rs.cell_i)


@pytest.fixture(scope="module")
def jax_pallas_runs():
    """JAX's pallas force backend (interpret mode), 1x1x1, f64, 24 steps."""
    out = {}
    with x64(True):
        s = jax_make_grappa_like(300, seed=11, dtype=np.float64)
        for nstprune in (0, 4):
            jeng = JaxMDEngine(s, jax_make_mesh((1, 1, 1), AXES),
                               JaxHaloSpec(AXES, (1, 1, 1), backend="pallas"),
                               force_backend="pallas", nstprune=nstprune)
            (cf, ci), m, d = jeng.simulate(24)
            pos, = jeng.gather_by_id([cf[..., :3]], ci)
            out[nstprune] = (m, d, pos, jeng.pair_stats(),
                             list(jeng.sched_history))
    return system_from_jax(s), out


@pytest.mark.parametrize("nstprune", [0, 4])
def test_pallas_backend_f64_1x1x1_matches_jax(jax_pallas_runs, nstprune):
    s, runs = jax_pallas_runs
    jm, jd, jpos, jstats, jhist = runs[nstprune]
    n_roll = ps.roll_prune.calls
    eng = MDEngine(s, make_mesh((1, 1, 1), AXES),
                   HaloSpec(AXES, (1, 1, 1), backend="pallas"),
                   force_backend="pallas", nstprune=nstprune, device="cpu")
    (cf, ci), m, d = eng.simulate(24)
    pos, = eng.gather_by_id([cf[..., :3]], ci)
    for k in ("pe", "ke"):
        rel = np.abs(m[k] - jm[k]).max() / np.abs(jm[k]).max()
        assert rel < 1e-9, (k, rel)
    assert np.abs(pos - jpos).max() / s.box[0] < 1e-9
    assert [[int(x[k]) for k in DIAG_KEYS] for x in d] == \
        [[int(np.asarray(x[k])) for k in DIAG_KEYS] for x in jd]
    stats = eng.pair_stats()
    assert stats.pop("pallas_fallback") is False
    jstats.pop("pallas_fallback")
    assert stats == jstats
    assert eng.sched_history == jhist
    # 24 steps = blocks of 20 and 4: 5 + 1 sub-blocks open with roll_prune
    assert ps.roll_prune.calls - n_roll == (6 if nstprune else 0)


def test_engine_degrades_to_dense_on_single_global_cell():
    s = make_grappa_like(110, seed=3)
    with pytest.warns(RuntimeWarning, match="degrades to the 'dense'"):
        eng = MDEngine(s, make_mesh((1, 1, 1), AXES), force_backend="sparse",
                       nstprune=5, device="cpu")
    assert min(eng.layout.global_cells) == 1
    assert eng.force_backend == "dense"
    assert eng.nstprune == 0 and eng.pair_schedule is None
    _, m, _ = eng.simulate(8)
    assert np.all(np.isfinite(m["pe"]))
    assert eng.pair_stats()["prune_ratio"] == 1.0


@pytest.mark.parametrize("kw,exc,match", [
    (dict(nstprune=21), ValueError, "exceeds the nstlist block length"),
    (dict(nstprune=-1), ValueError, "nstprune must be >= 0"),
    (dict(nstprune=4, inner_radius=2.0), ValueError, "< r_cut"),
    (dict(force_backend="blocked"), ValueError, "unknown force backend"),
])
def test_engine_rejects_bad_prune_configs(kw, exc, match):
    s = make_grappa_like(300, seed=11)
    kw = {"force_backend": "sparse", **kw}
    with pytest.raises(exc, match=match):
        MDEngine(s, make_mesh((1, 1, 1), AXES), device="cpu", **kw)


def test_force_backend_registry_matches_reference():
    assert force_backends() == jps.force_backends()
    # one evaluator under both pruned names: on the card each launches
    # the kernels, on the CPU each takes their plain forms
    assert ps.get_force_backend("sparse") is ps.get_force_backend("pallas")
    with pytest.raises(ValueError, match="unknown force backend"):
        ps.get_force_backend("nope")


def test_overflow_falls_back_to_the_outer_ladder():
    """A margin-free inner ladder overflows: the engine warns once, counts
    the block, and runs the next block on the outer ladder."""
    s = make_grappa_like(300, seed=11)
    eng = MDEngine(s, make_mesh((1, 1, 1), AXES),
                   HaloSpec(AXES, (1, 1, 1), backend="serialized"),
                   force_backend="sparse", nstprune=4, inner_safety=1e-9,
                   device="cpu")
    with pytest.warns(RuntimeWarning, match="overflowed its tier ladder"):
        _, m, _ = eng.simulate(24)
    assert np.all(np.isfinite(m["pe"]))
    # the first block overflowed; the second ran the outer ladder, which
    # has no inner budget to overflow
    assert eng.pair_stats()["inner_overflow_blocks"] == 1
    assert eng._pair_stats["inner_disabled"]
    (o1, i1), (o2, i2) = eng.sched_history
    assert i1 < o1 and i2 == o2
