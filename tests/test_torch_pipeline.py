"""The port's step pipeline, signal ledger and schedule verifier against
the JAX package's.

* The reference's toy conformance matrix (backend x pipeline mode x halo
  width x window depth, 48 cells) on the port's 1-domain mesh and on a
  3-domain ring: every cell bitwise equal to the port's serialized / off
  cell, with the same ledger summary key for key.  The signal cells are
  also held against JAX's same cell: state, forces and metrics within
  1e-5 of their scale in f32 (XLA's and torch's ``tanh`` and sums may
  differ by an ulp per step), the ledger summary exactly.
* Blocks shorter than the window (``n_steps < depth``, ``n_steps = 1``).
* Ledger replays against the JAX ``SignalLedger``, state for state.
* Verifier parity: every cell of the two conformance grids gives the same
  report in both packages, and the reference's bad configs raise the
  same error class with the same message.
"""
import functools

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # property tests skip; hypothesis is a dev extra
    from _hypothesis_stub import given, settings, st

jax = pytest.importorskip("jax")   # the JAX package is the reference

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.analysis import grids as jax_grids  # noqa: E402
from repro.analysis import schedule_verifier as jax_sv  # noqa: E402
from repro.compat import shard_map_norep  # noqa: E402
from repro.core import halo_plan as jax_halo_plan  # noqa: E402
from repro.core import pipeline as jax_pipeline  # noqa: E402
from repro.launch.mesh import make_mesh as jax_make_mesh  # noqa: E402
from repro_torch.analysis import grids  # noqa: E402
from repro_torch.analysis import schedule_verifier as sv  # noqa: E402
from repro_torch.core.halo_plan import HaloPlan, HaloSpec  # noqa: E402
from repro_torch.core.pipeline import (  # noqa: E402
    PIPELINE_MODES,
    SignalLedger,
    StepFns,
    StepPipeline,
)
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from _torch_threads import share_cores  # noqa: E402

MATRIX_BACKENDS = ("serialized", "fused", "pallas", "signal")
MATRIX_MODES = ("off", "double_buffer")
MATRIX_WIDTHS = (1, 2)
MATRIX_DEPTHS = (2, 3, 4)
MATRIX_STEPS = 8     # 7 post-prologue steps: exercises rem != 0 at span 2/3
MATRIX = [(b, m, w, d)
          for b in MATRIX_BACKENDS
          for m in MATRIX_MODES
          for w in MATRIX_WIDTHS
          for d in MATRIX_DEPTHS]
LOCAL = (6, 4)
TOL = 1e-5           # f32, relative to the compared array's scale


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """Run this module's PyTorch ops on the worker's share of the cores."""
    yield from share_cores()


def _x0(n_dom):
    """The reference's toy state on one domain; more domains stack more
    draws of the same generator."""
    x = np.random.RandomState(0).randn(n_dom * LOCAL[0], LOCAL[1])
    return x.astype(np.float32).reshape((n_dom,) + LOCAL)


# --------------------------------------------------------------------------
# the toy physics, in both packages
# --------------------------------------------------------------------------

def _port_toy_fns():
    """``tests/test_pipeline.py``'s toy on block tensors: the per-domain
    sum ``aux`` of the reference's device-local ``state.sum()``."""
    def begin(state, f, ctx):
        state = state + 0.1 * f
        return state, state.sum(dim=(1, 2), keepdim=True), state

    def force(ext, ctx):
        F = torch.tanh(ext) * ctx
        return F, {"pe": torch.sum(F)}

    def finish(state, aux, f, ctx):
        state = state + 0.01 * f + 1e-3 * aux
        return state, f, {"ke": torch.sum(state)}

    return StepFns(begin=begin, force=force, finish=finish)


def _jax_toy_fns():
    def begin(state, f, ctx):
        state = state + 0.1 * f
        return state, state.sum(), state

    def force(ext, ctx):
        F = jnp.tanh(ext) * ctx
        return F, {"pe": jnp.sum(F)}

    def finish(state, aux, f, ctx):
        state = state + 0.01 * f + 1e-3 * aux
        return state, f, {"ke": jnp.sum(state)}

    return jax_pipeline.StepFns(begin=begin, force=force, finish=finish)


def _port_pipe(backend, mode, width, depth, n_dom, **kw):
    plan = HaloPlan.build(HaloSpec(("z",), (width,), backend=backend),
                          make_mesh((n_dom,), ("z",)), device="cpu")
    return StepPipeline.build(plan, _port_toy_fns(), mode=mode, depth=depth,
                              **kw)


@functools.lru_cache(maxsize=None)
def _port_cell(backend, mode, width, depth, n_dom, n_steps=MATRIX_STEPS):
    if mode == "off":
        depth = 2        # the serialized chain has no ring to deepen
    pipe = _port_pipe(backend, mode, width, depth, n_dom)
    x0 = torch.from_numpy(_x0(n_dom))
    state, f, metrics, led = pipe.run_local(x0, torch.zeros_like(x0),
                                            n_steps, torch.tensor(0.5))
    return (state.numpy(), f.numpy(),
            {k: v.numpy() for k, v in metrics.items()},
            pipe.ledger.summary(led), led)


@functools.lru_cache(maxsize=None)
def _jax_cell(backend, mode, width, depth, n_steps=MATRIX_STEPS):
    """The reference's ``_run_cell`` (one device, periodic self-exchange)."""
    if mode == "off":
        depth = 2
    mesh = jax_make_mesh((1,), ("z",))
    plan = jax_halo_plan.HaloPlan.build(
        jax_halo_plan.HaloSpec(("z",), (width,), backend=backend), mesh)
    pipe = jax_pipeline.StepPipeline.build(plan, _jax_toy_fns(), mode=mode,
                                           depth=depth)
    x0 = jnp.asarray(_x0(1)[0])

    def run(state, f):
        return pipe.run_local(state, f, n_steps, jnp.float32(0.5))

    fn = shard_map_norep(run, mesh=mesh, in_specs=(P(), P()),
                         out_specs=(P(), P(), P(), P()))
    state, f, metrics, led = jax.jit(fn)(x0, jnp.zeros_like(x0))
    return (np.asarray(state), np.asarray(f),
            {k: np.asarray(v) for k, v in metrics.items()},
            pipe.ledger.summary(jax.device_get(led)), pipe,
            jax.device_get(led))


# --------------------------------------------------------------------------
# the conformance matrix
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_dom", [1, 3], ids=["dom1", "ring3"])
@pytest.mark.parametrize(
    "backend,mode,width,depth", MATRIX,
    ids=[f"{b}-{m}-w{w}-d{d}" for b, m, w, d in MATRIX])
def test_conformance_matrix(backend, mode, width, depth, n_dom):
    """Bitwise identity of every cell with serialized / off, and the
    ledger conservation laws (balanced, causal, clobber-free, drained)."""
    ref = _port_cell("serialized", "off", width, 2, n_dom)
    got = _port_cell(backend, mode, width, depth, n_dom)
    assert np.array_equal(got[0], ref[0])
    assert np.array_equal(got[1], ref[1])
    assert list(got[2]) == list(ref[2]) == ["pe", "ke"]
    for k in ref[2]:
        assert ref[2][k].shape[0] == MATRIX_STEPS
        assert np.array_equal(got[2][k], ref[2][k]), k
    summary = got[3]
    assert summary == ref[3]
    assert summary["consistent"] and summary["window_safe"]
    assert summary["in_flight"] == 0 and summary["clobbers"] == 0
    for kind in ("fwd", "rev"):
        assert summary[kind] == {"released": MATRIX_STEPS,
                                 "acquired": MATRIX_STEPS}


def _close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    return float(np.abs(got - want).max()) <= TOL * scale


@pytest.mark.parametrize("depth", (2, 3, 4))
@pytest.mark.parametrize("width", MATRIX_WIDTHS)
@pytest.mark.parametrize("mode", MATRIX_MODES)
def test_signal_cells_match_jax(mode, width, depth):
    want = _jax_cell("signal", mode, width, depth)
    got = _port_cell("signal", mode, width, depth, 1)
    assert _close(got[0][0], want[0]) and _close(got[1][0], want[1])
    assert sorted(got[2]) == sorted(want[2])
    for k in want[2]:
        assert got[2][k].shape == want[2][k].shape
        assert _close(got[2][k], want[2][k]), k
    assert got[3] == want[3]
    # the ledger after the run, slot for slot
    for name in ("released", "acquired", "clobbers"):
        assert np.array_equal(getattr(got[4], name),
                              np.asarray(getattr(want[5], name))), name
    port = _port_pipe("signal", mode, width, depth, 1)
    assert (port.mode, port.depth) == (want[4].mode, want[4].depth)
    assert port.ledger == SignalLedger(want[4].ledger.depth,
                                       want[4].ledger.n_pulses)
    assert port.stats((6,), feature_elems=4) == \
        want[4].stats((6,), feature_elems=4)


@pytest.mark.parametrize("n_steps", (1, 2, 3, 4, 5))
@pytest.mark.parametrize("depth", (2, 3, 4))
def test_deep_window_short_blocks(depth, n_steps):
    """Blocks around the window's length: the prologue, no or one or
    two whole windows, the epilogue drain and the final finish, still
    bitwise equal to off on one domain and on a ring of three."""
    for n_dom in (1, 3):
        ref = _port_cell("signal", "off", 1, 2, n_dom, n_steps=n_steps)
        got = _port_cell("signal", "double_buffer", 1, depth, n_dom,
                         n_steps=n_steps)
        assert np.array_equal(got[0], ref[0])
        assert np.array_equal(got[1], ref[1])
        for k in ref[2]:
            assert np.array_equal(got[2][k], ref[2][k])
        assert got[3] == ref[3]
        assert got[3]["in_flight"] == 0 and got[3]["window_safe"]


def test_pipeline_rejects_bad_mode_and_depth():
    with pytest.raises(ValueError, match="unknown pipeline mode"):
        _port_pipe("fused", "triple", 1, 2, 1)
    with pytest.raises(ValueError, match="depth >= 2"):
        _port_pipe("fused", "double_buffer", 1, 1, 1)
    # "off" has no ring: depth is normalized away, not an error
    assert _port_pipe("fused", "off", 1, 7, 1).depth == 1
    with pytest.raises(ValueError, match="n_steps must be >= 1"):
        _port_pipe("fused", "off", 1, 2, 1).run_local(
            torch.zeros((1,) + LOCAL), torch.zeros((1,) + LOCAL), 0)
    assert PIPELINE_MODES == jax_pipeline.PIPELINE_MODES == sv.MODES


def test_pipeline_build_gate():
    """``StepPipeline.build`` runs the verifier's gate and records the
    report; ``verify="off"`` skips it."""
    pipe = _port_pipe("signal", "double_buffer", 1, 3, 1)
    assert pipe.schedule_report is not None and pipe.schedule_report.safe
    assert pipe.schedule_report.to_dict() == jax_sv.verify_build(
        mode="double_buffer", depth=3, n_pulses=1,
        backend="signal").to_dict()
    assert _port_pipe("fused", "off", 1, 2, 1,
                      verify="off").schedule_report is None
    with pytest.raises(ValueError, match="unknown verify mode"):
        _port_pipe("fused", "off", 1, 2, 1, verify="loud")


# --------------------------------------------------------------------------
# the signal ledger against the reference's
# --------------------------------------------------------------------------

def _replay(led, depth, n_steps, watch):
    """The deep-window pipeline's ledger transitions (prologue, skew-one
    steps with release-at-fill, epilogue drain), ``watch`` after each."""
    s = led.init()
    s = watch(led.release(s, "fwd", 0))
    s = watch(led.acquire(s, "fwd", 0))
    s = watch(led.release(s, "rev", 0))
    for k in range(1, n_steps):
        s = watch(led.acquire(s, "rev", k - 1))
        s = watch(led.release(s, "fwd", k))
        s = watch(led.acquire(s, "fwd", k))
        s = watch(led.release(s, "rev", k))
    return watch(led.acquire(s, "rev", n_steps - 1))


def _ledger_parity(depth, n_steps, n_pulses):
    port = SignalLedger(depth=depth, n_pulses=n_pulses)
    ref = jax_pipeline.SignalLedger(depth=depth, n_pulses=n_pulses)
    seen = []
    st_p = _replay(port, depth, n_steps, lambda s: seen.append(s) or s)
    i = iter(seen)

    def watch(s):
        mine = next(i)
        for name in ("released", "acquired", "clobbers"):
            assert np.array_equal(getattr(mine, name),
                                  np.asarray(getattr(s, name))), name
        assert port.consistent(mine) == bool(ref.consistent(s))
        assert port.window_safe(mine) == bool(ref.window_safe(s))
        assert port.in_flight(mine) == int(ref.in_flight(s))
        assert port.in_flight(mine) <= n_pulses   # skew-one window
        return s

    st_r = _replay(ref, depth, n_steps, watch)
    assert port.drained(st_p) and bool(ref.drained(st_r))
    s = port.summary(st_p)
    assert s == ref.summary(jax.device_get(st_r))
    # released counts every pulse's signal: n_steps x n_pulses (the
    # reference's own property test expects n_steps)
    for kind in ("fwd", "rev"):
        assert s[kind] == {"released": n_steps * n_pulses,
                           "acquired": n_steps * n_pulses}


def test_ledger_per_pulse_count_pinned():
    _ledger_parity(depth=2, n_steps=1, n_pulses=2)


@given(depth=st.integers(2, 6), n_steps=st.integers(1, 12),
       n_pulses=st.integers(1, 3))
@settings(max_examples=20, deadline=None)
def test_ledger_replay_matches_jax(depth, n_steps, n_pulses):
    _ledger_parity(depth, n_steps, n_pulses)


def test_ledger_clobber_and_causality_match_jax():
    for port, ref in ((SignalLedger(2, 1), jax_pipeline.SignalLedger(2, 1)),
                      (SignalLedger(3, 2), jax_pipeline.SignalLedger(3, 2))):
        sp, sr = port.init(), ref.init()
        for op, kind, buf in (("release", "rev", 0), ("release", "rev", 0),
                              ("acquire", "fwd", 1), ("release", "rev", 2),
                              ("acquire", "rev", 0), ("release", "rev", 0)):
            sp = getattr(port, op)(sp, kind, buf)
            sr = getattr(ref, op)(sr, kind, buf)
            assert port.summary(sp) == ref.summary(jax.device_get(sr))
        assert not port.window_safe(sp) and not port.consistent(sp)
    with pytest.raises(ValueError, match=">= 1"):
        SignalLedger(depth=0, n_pulses=1)


# --------------------------------------------------------------------------
# verifier parity
# --------------------------------------------------------------------------

def _fields(cfg):
    return {k: getattr(cfg, k) for k in (
        "mode", "depth", "n_steps", "window", "n_pulses", "nstprune",
        "overlap_rebin", "backend", "force_backend", "step_barrier")}


def test_grids_match_jax():
    assert [_fields(c) for c in grids.full_grid()] == \
        [_fields(c) for c in jax_grids.full_grid()]
    assert len(grids.pr4_grid()) == 48


EXTRA_CFGS = [dict(mode="double_buffer", depth=2, window=3),
              dict(mode="double_buffer", depth=3, window=2,
                   step_barrier=False),
              dict(mode="double_buffer", depth=4, n_pulses=3, nstprune=3,
                   n_steps=10, overlap_rebin=True, force_backend="sparse")]


@pytest.mark.parametrize("i", range(len(grids.full_grid()) + len(EXTRA_CFGS)))
def test_verifier_reports_match_jax(i):
    cells = grids.full_grid()
    if i < len(cells):
        cfg, ref_cfg = cells[i], jax_grids.full_grid()[i]
    else:
        kw = EXTRA_CFGS[i - len(cells)]
        cfg, ref_cfg = sv.ScheduleConfig(**kw), jax_sv.ScheduleConfig(**kw)
    got, want = sv.verify_schedule(cfg), jax_sv.verify_schedule(ref_cfg)
    assert got.to_dict() == want.to_dict()
    assert got.summary() == want.summary()
    assert got.counterexample() == want.counterexample()
    if i < len(cells):
        assert got.safe


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return type(e).__name__, str(e)
    return None


_MD_BASE = dict(nstlist=20, nstprune=0, pipeline="double_buffer",
                pipeline_depth=2, overlap_rebin=False, force_backend="sparse")

BAD_CALLS = {
    **{f"config-{k}": ("verify_schedule", dict(cfg=kw)) for k, kw in [
        ("mode", dict(mode="triple")),
        ("db-depth", dict(mode="double_buffer", depth=1)),
        ("depth", dict(depth=0)),
        ("n_steps", dict(n_steps=0)),
        ("window", dict(window=0)),
        ("n_pulses", dict(n_pulses=0)),
        ("nstprune", dict(nstprune=-1))]},
    "halo-dup": ("check_halo_config", (("z", "z"), (1, 1))),
    "halo-neg": ("check_halo_config", (("z",), (-1,))),
    "halo-len": ("check_halo_config", (("z", "y"), (1,))),
    "halo-pulse0": ("check_halo_config", (("z",), (1,), (0,))),
    "from-spec-dup": ("from_spec", (("z", "z"), (1, 1))),
    **{f"md-{k}": ("check_md_config", dict(_MD_BASE, **kw)) for k, kw in [
        ("nstlist", dict(nstlist=0)),
        ("nstprune", dict(nstprune=25)),
        ("inner_safety", dict(nstprune=4, inner_safety=0.0)),
        ("r_list", dict(r_list_factor=0.9)),
        ("mig", dict(mig_frac=0.0)),
        ("capacity", dict(capacity_safety=0.5))]},
    "gate-md": ("gate_md_build", dict(_MD_BASE, nstprune=25)),
    "gate-pipe-clobber": ("gate_pipeline_build", dict(
        mode="double_buffer", depth=2, n_pulses=1, backend="signal",
        window=3)),
    "gate-pipe-verify": ("gate_pipeline_build", dict(
        mode="off", depth=2, n_pulses=1, backend="signal", verify="loud")),
}


def _call(mod, name, args):
    if name == "verify_schedule":
        return lambda: mod.verify_schedule(mod.ScheduleConfig(**args["cfg"]))
    if name == "from_spec":
        return lambda: mod.ScheduleConfig.from_spec(*args)
    fn = getattr(mod, name)
    if isinstance(args, dict):
        return lambda: fn(**args)
    return lambda: fn(*args)


@pytest.mark.parametrize("case", list(BAD_CALLS))
def test_bad_configs_raise_like_jax(case):
    name, args = BAD_CALLS[case]
    want = _raised(_call(jax_sv, name, args))
    got = _raised(_call(sv, name, args))
    assert want is not None and got == want


def test_verifier_warn_and_off_like_jax():
    bad = dict(_MD_BASE, nstprune=25)
    with pytest.warns(RuntimeWarning, match="rejected by the static"):
        assert sv.gate_md_build(**bad, verify="warn") is None
    assert sv.gate_md_build(**bad, verify="off") is None
    with pytest.warns(RuntimeWarning, match="statically unsafe"):
        rep = sv.gate_pipeline_build(mode="double_buffer", depth=2,
                                     n_pulses=1, backend="signal",
                                     window=3, verify="warn")
    assert not rep.safe
    good = dict(_MD_BASE, nstprune=4, pipeline_depth=3, overlap_rebin=True)
    assert sv.gate_md_build(**good).to_dict() == \
        jax_sv.gate_md_build(**good).to_dict()
