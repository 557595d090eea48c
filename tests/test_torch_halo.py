"""Port's HaloPlan against the JAX HaloPlan, and its own invariants.

On a 1x1x1 mesh every backend's fwd and rev must equal the JAX plan's
bit for bit (f32 with wrap shifts, int32 without).  On multi-domain
virtual meshes the port is held to the reference's own bar: fwd bitwise
across backends (and equal to a numpy periodic-image oracle), the adjoint
identity, and pallas / signal rev == serialized rev bitwise.  The
accounting dicts must equal the JAX plan's exactly.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the JAX package is the reference

import jax.numpy as jnp  # noqa: E402

from repro.analysis.schedule_verifier import check_halo_config
from repro.core import halo_plan as jax_halo_plan
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro_torch.convert import cells_to_domains
from repro_torch.core import halo_plan
from repro_torch.core.halo_plan import HaloPlan, HaloSpec
from repro_torch.launch.mesh import make_mesh
from _torch_threads import share_cores  # noqa: E402

AXES = ("z", "y", "x")
BACKENDS = ("serialized", "fused", "pallas", "signal")
CONFIGS = {"w111": ((1, 1, 1), None), "w121": ((1, 2, 1), None),
           "w222p222": ((2, 2, 2), (2, 2, 2))}
LOCAL = (4, 3, 5)
F = 3


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """Run this module's PyTorch ops on the worker's share of the cores."""
    yield from share_cores()


def _shift():
    s = np.zeros((3, F))
    s[0, 0], s[1, 1], s[2, 2] = 10.0, 20.0, 30.0
    return s


def _port_plan(backend, widths, pulses, mesh_shape=(1, 1, 1)):
    spec = HaloSpec(axis_names=AXES, widths=widths, backend=backend,
                    pulses=pulses, wrap_shift=_shift())
    return HaloPlan.build(spec, make_mesh(mesh_shape, AXES), device="cpu")


def _payload(rng, shape, dtype):
    if dtype == np.int32:
        return rng.randint(-50, 50, size=shape).astype(np.int32)
    return rng.randn(*shape).astype(dtype)


# --------------------------------------------------------------------------
# against the JAX plan on one domain
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("backend", BACKENDS)
def test_fwd_rev_match_jax_bitwise(backend, config, dtype, monkeypatch):
    widths, pulses = CONFIGS[config]
    rng = np.random.RandomState(sum(widths) + len(backend))
    # which path JAX's signal backend takes: with three named mesh axes in
    # scope its interpret-mode kernels cannot emulate the remote puts, so
    # it runs its jnp oracle, which has the kernels' semantics
    kernel_ok = []
    from repro.core.pipeline.signal_backend import SignalBackend
    real = SignalBackend._kernel_ok
    monkeypatch.setattr(SignalBackend, "_kernel_ok", lambda self, plan: (
        kernel_ok.append(real(self, plan)) or kernel_ok[-1]))
    jplan = jax_halo_plan.HaloPlan.build(
        jax_halo_plan.HaloSpec(axis_names=AXES, widths=widths,
                               backend=backend, pulses=pulses,
                               wrap_shift=_shift()),
        jax_make_mesh((1, 1, 1), AXES))
    plan = _port_plan(backend, widths, pulses)
    shift = {} if dtype == np.float32 else {"wrap_shift": None}

    x = _payload(rng, LOCAL + (F,), dtype)
    want = np.asarray(jplan.fwd(jnp.asarray(x), **shift))
    got = plan.fwd(torch.from_numpy(x)[None, None, None], **shift)
    assert got.shape[3:] == want.shape
    assert np.array_equal(got[0, 0, 0].numpy(), want)

    y = _payload(rng, want.shape, dtype)
    want_r = np.asarray(jplan.rev(jnp.asarray(y)))
    got_r = plan.rev(torch.from_numpy(y)[None, None, None])
    assert np.array_equal(got_r[0, 0, 0].numpy(), want_r)
    # pallas: the JAX kernels really ran; signal: its oracle ran
    assert jplan._pallas_broken is False
    assert kernel_ok == ([False] * len(kernel_ok) if backend == "signal"
                         else [])
    if backend == "signal":
        assert kernel_ok


# --------------------------------------------------------------------------
# multi-domain virtual meshes, within the port
# --------------------------------------------------------------------------

def _periodic_oracle(X, mesh_shape, widths, shift):
    """Extended blocks from the global array: domain i's block along d
    reaches ``widths[d]`` rows into domain i+1 (periodic), adding
    ``shift[d]`` once per wrapped dim, in z, y, x order."""
    G = X.shape[:3]
    n = [G[d] // mesh_shape[d] for d in range(3)]
    out = np.zeros(tuple(mesh_shape) + tuple(n[d] + widths[d]
                                             for d in range(3)) + (F,),
                   X.dtype)
    for dom in np.ndindex(*mesh_shape):
        g = [dom[d] * n[d] + np.arange(n[d] + widths[d]) for d in range(3)]
        blk = X[np.ix_(g[0] % G[0], g[1] % G[1], g[2] % G[2])]
        for d in range(3):
            view = [1, 1, 1, 1]
            view[d] = -1
            wrapped = (g[d] >= G[d]).astype(X.dtype).reshape(view)
            blk = blk + wrapped * shift[d].astype(X.dtype)
        out[dom] = blk
    return out


MESHES = [(2, 2, 2), (2, 1, 1), (3, 2, 1)]


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda m: "x".join(
    map(str, m)))
def test_virtual_mesh_backends_agree(mesh_shape, config):
    widths, pulses = CONFIGS[config]
    rng = np.random.RandomState(len(config) + sum(mesh_shape))
    G = tuple(mesh_shape[d] * LOCAL[d] for d in range(3))
    X = rng.randn(*G, F).astype(np.float32)
    x = torch.from_numpy(np.ascontiguousarray(
        cells_to_domains(X, X, mesh_shape)[0]))
    oracle = _periodic_oracle(X, mesh_shape, widths, _shift())

    exts, revs = {}, {}
    y = torch.from_numpy(rng.randn(*oracle.shape).astype(np.float32))
    for b in BACKENDS:
        plan = _port_plan(b, widths, pulses, mesh_shape)
        exts[b] = plan.fwd(x)
        revs[b] = plan.rev(y)
        # adjoint identity <fwd x, y> == <x, rev y>, without the shifts
        plain = plan.fwd(x, wrap_shift=None)
        lhs = float(torch.sum(plain.double() * y.double()))
        rhs = float(torch.sum(x.double() * revs[b].double()))
        assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1.0), (b, lhs, rhs)
    for b in BACKENDS:
        assert np.array_equal(exts[b].numpy(), oracle), b
    assert torch.equal(revs["pallas"], revs["serialized"])
    assert torch.equal(revs["signal"], revs["serialized"])


def test_virtual_mesh_int32_pallas_matches_serialized():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randint(-9, 9, (3, 2, 1) + LOCAL + (2,))
                         .astype(np.int32))
    plans = {b: _port_plan(b, (1, 2, 1), None, (3, 2, 1))
             for b in ("serialized", "pallas", "signal")}
    ext = {b: p.fwd(x, wrap_shift=None) for b, p in plans.items()}
    for b in ("pallas", "signal"):
        assert torch.equal(ext[b], ext["serialized"]), b
        assert torch.equal(plans[b].rev(ext[b]),
                           plans["serialized"].rev(ext["serialized"])), b


def test_signal_backend_refuses_multi_hop_widths():
    """A halo wider than the local block needs multi-hop forwarding, which
    the signal backend (like the reference's) does not implement."""
    plan = _port_plan("signal", (5, 1, 1), None)
    with pytest.raises(NotImplementedError, match="multi-hop"):
        plan.fwd(torch.zeros((1, 1, 1) + LOCAL + (F,)))


# --------------------------------------------------------------------------
# accounting, validation, unported features
# --------------------------------------------------------------------------

STATS_KW = [dict(), dict(itemsize=8, feature_elems=160, index_elems=80,
                         occupancy=0.43),
            dict(pipeline="double_buffer", depth=3,
                 link_latency_s=2e-6, bandwidth_Bps=1e11)]


@pytest.mark.parametrize("kw", range(len(STATS_KW)))
@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("backend", BACKENDS)
def test_stats_equal_jax(backend, config, kw):
    widths, pulses = CONFIGS[config]
    jplan = jax_halo_plan.HaloPlan.build(
        jax_halo_plan.HaloSpec(axis_names=AXES, widths=widths,
                               backend=backend, pulses=pulses,
                               feature_elems=4),
        jax_make_mesh((1, 1, 1), AXES))
    plan = HaloPlan.build(HaloSpec(axis_names=AXES, widths=widths,
                                   backend=backend, pulses=pulses,
                                   feature_elems=4),
                          make_mesh((2, 2, 2), AXES), device="cpu")
    local = (7, 7, 7)
    want = jplan.stats(local, **STATS_KW[kw])
    got = plan.stats(local, **STATS_KW[kw])
    assert got == want
    assert halo_plan.latency_model(got, 1e-6, 2e10) == \
        jax_halo_plan.latency_model(want, 1e-6, 2e10)
    for pipe, depth in (("off", 2), ("double_buffer", 2),
                        ("double_buffer", 4)):
        assert halo_plan.overlap_model(got, plan.backend.critical_path,
                                       pipe, depth) == \
            jax_halo_plan.overlap_model(want, jplan.backend.critical_path,
                                        pipe, depth)


@pytest.mark.parametrize("names,widths,pulses", [
    (("z", "z", "x"), (1, 1, 1), None),
    (AXES, (1, -1, 1), None),
    (AXES, (1, 1, 1), (1, 2, 1)),
    (AXES, (2, 2, 2), (0, 1, 1)),
])
def test_config_errors_match_jax(names, widths, pulses):
    with pytest.raises(ValueError) as want:
        check_halo_config(names, widths, pulses)
    with pytest.raises(ValueError) as got:
        HaloPlan.build(HaloSpec(axis_names=names, widths=widths,
                                pulses=pulses),
                       make_mesh((1, 1, 1), AXES), device="cpu")
    assert str(got.value) == str(want.value)


def test_pallas_maps_checked_against_the_block(monkeypatch):
    """The CUDA kernels trust the index maps, so the plan checks each map
    against the block's row count once, when it builds it."""
    plan = _port_plan("pallas", (1, 1, 1), None)
    good = halo_plan.PallasBackend._rows_along
    monkeypatch.setattr(halo_plan.PallasBackend, "_rows_along", staticmethod(
        lambda shape, d, lo, hi: good(shape, d, lo, hi) + 10_000))
    x = torch.zeros((1, 1, 1) + LOCAL + (F,))
    with pytest.raises(ValueError, match="index map"):
        plan.fwd(x)


def test_unported_features_raise():
    mesh = make_mesh((1, 1, 1), AXES)
    with pytest.raises(ValueError, match="unknown halo backend"):
        HaloPlan.build(HaloSpec(AXES, (1, 1, 1), backend="nope"), mesh,
                       device="cpu")
    plan = HaloPlan.build(HaloSpec(AXES, (1, 1, 1)), mesh, device="cpu")
    with pytest.raises(ValueError, match="no axis"):
        HaloPlan.build(HaloSpec(("q",), (1,)), mesh, device="cpu")
    with pytest.raises(ValueError, match="unknown verify mode"):
        HaloPlan.build(HaloSpec(AXES, (1, 1, 1)), mesh, device="cpu",
                       verify="loud")
    with pytest.raises(ValueError, match="domain dims"):
        plan.fwd(torch.zeros((2, 1, 1, 2, 2, 2, 1)))
