"""The port's 24-step f64 MD trajectories on one domain against the JAX
MDEngine (per-step PE / KE to 1e-9 relative, final positions to 1e-9 of
the box, halo / overlap / pair stats equal), and within the port the
pallas, signal and serialized halo backends and the off and double_buffer
pipelines bitwise equal (2x2x2, and 3x2x2 for the roll signs).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the JAX package is the reference

from _torch_md_common import (  # noqa: E402
    AXES,
    _assert_trajectories_agree,
    _jax_engine,
    _port_engine,
    x64,
)
from repro.core.md import make_grappa_like as jax_make_grappa_like  # noqa: E402
from repro_torch.convert import system_from_jax  # noqa: E402
from repro_torch.core.halo_plan import HaloSpec  # noqa: E402
from repro_torch.core.md import MDEngine, make_grappa_like  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from _torch_threads import share_cores  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """Run this module's PyTorch ops on the worker's share of the cores."""
    yield from share_cores()


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


@pytest.mark.parametrize("mesh_shape,widths,pulses", [
    pytest.param((3, 2, 2), (1, 1, 1), None, id="3x2x2"),
    pytest.param((2, 2, 2), (2, 2, 2), (2, 2, 2), id="2x2x2-w2p2"),
])
def test_signal_double_buffer_equals_serialized_off(mesh_shape, widths,
                                                    pulses):
    """signal / double_buffer against serialized / off, bitwise, across a
    fused rebin: on 3x2x2 (size-3 domain axes tell the two put directions
    apart, which size-2 axes cannot) and with two-pulse dims, which take
    ``fused_pulses`` (local blocks of 2 cells, so 1600 atoms)."""
    runs = {}
    s = make_grappa_like(1600, seed=4)
    for backend, kw in (("serialized", {}),
                        ("signal", dict(pipeline="double_buffer",
                                        pipeline_depth=2,
                                        overlap_rebin=True))):
        eng = MDEngine(s, make_mesh(mesh_shape, AXES),
                       HaloSpec(AXES, widths, backend=backend,
                                pulses=pulses), device="cpu", **kw)
        (cf, ci), m, d = eng.simulate(22)
        runs[backend] = (cf, ci, m, d)
    p, q = runs["signal"], runs["serialized"]
    assert torch.equal(p[0], q[0]) and torch.equal(p[1], q[1])
    for k in ("pe", "ke", "mom"):
        assert np.array_equal(p[2][k], q[2][k]), k
    assert p[3] == q[3] and len(p[3]) == 2


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
