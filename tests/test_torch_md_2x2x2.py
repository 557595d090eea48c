"""The port's MD slice on a 2x2x2 mesh against one JAX run on 8 virtual
devices (in a subprocess): 24-step f64 trajectories, per-step PE / KE to
1e-9 relative and final positions to 1e-9 of the box, for the dense run,
the pruned "sparse" backend (nstprune 0 and 4) and the signal backend
under the depth-3 double-buffered pipeline with the fused rebin; and the
pruned signal / double_buffer runs bitwise against the port's pruned off
(the same cached port runs).
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the JAX package is the reference

from _torch_md_common import (  # noqa: E402
    AXES,
    DIAG_KEYS,
    REPO,
    _assert_trajectories_agree,
)
from repro_torch.core.halo_plan import HaloSpec  # noqa: E402
from repro_torch.core.md import MDEngine, make_grappa_like  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from _torch_threads import share_cores  # noqa: E402


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
# the dense run, the pruned "sparse" backend with nstprune 0 and 4, and
# the signal backend under the depth-3 double buffer with the fused rebin
for tag, backend, kw in (
        ("", "pallas", {}),
        ("sparse0_", "pallas", dict(force_backend="sparse")),
        ("sparse4_", "pallas", dict(force_backend="sparse", nstprune=4)),
        ("signal_", "signal", dict(pipeline="double_buffer",
                                   pipeline_depth=3, overlap_rebin=True))):
    eng = MDEngine(s, make_mesh((2, 2, 2), ("z", "y", "x")),
                   HaloSpec(("z", "y", "x"), (1, 1, 1), backend=backend),
                   **kw)
    (cf, ci), m, d = eng.simulate(24)
    pos, = eng.gather_by_id([cf[..., :3]], ci)
    out.update({tag + "pe": m["pe"], tag + "ke": m["ke"],
                tag + "mom": m["mom"], tag + "pos": pos,
                tag + "diags": np.array([[int(x[k]) for k in keys]
                                         for x in d]),
                tag + "sched_history": np.array(eng.sched_history)})
    out[tag + "pallas_broken"] = eng.plan._pallas_broken
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """Run this module's PyTorch ops on the worker's share of the cores."""
    yield from share_cores()


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


def _ref_run(jax_dd_reference, tag):
    return {k[len(tag):]: v for k, v in jax_dd_reference.items()
            if k.startswith(tag)}


@functools.lru_cache(maxsize=None)
def _port_dd_run(mesh_shape=(2, 2, 2), n_atoms=900, seed=3,
                 backend="pallas", **kw):
    """One f64 24-step port run on the CPU (cached: several tests compare
    against the same run)."""
    s = make_grappa_like(n_atoms, seed=seed, dtype=np.float64)
    eng = MDEngine(s, make_mesh(mesh_shape, AXES),
                   HaloSpec(AXES, (1, 1, 1), backend=backend), device="cpu",
                   **kw)
    (cf, ci), m, d = eng.simulate(24)
    pos, = eng.gather_by_id([cf[..., :3]], ci)
    return s, eng, (cf, ci), m, d, pos


def _assert_runs_bitwise(a, b):
    """Two ``_port_dd_run`` results: final state, per-step metrics,
    migration diagnostics and (pruned) schedule history identical."""
    assert torch.equal(a[2][0], b[2][0]) and torch.equal(a[2][1], b[2][1])
    for k in ("pe", "ke", "mom"):
        assert np.array_equal(a[3][k], b[3][k]), k
    assert a[4] == b[4]
    assert a[1].sched_history == b[1].sched_history


def test_whole_slice_f64_2x2x2_matches_jax(jax_dd_reference):
    ref = _ref_run(jax_dd_reference, "")
    assert not bool(ref["pallas_broken"])
    s, _eng, _state, m, d, pos = _port_dd_run()
    ref_d = [dict(zip(DIAG_KEYS, row)) for row in ref["diags"]]
    _assert_trajectories_agree(m, d, pos, ref, ref_d, ref["pos"], s.box[0])
    assert np.abs(m["mom"] - ref["mom"]).max() < 1e-9


def test_signal_double_buffer_f64_2x2x2_matches_jax(jax_dd_reference):
    """signal / double_buffer / depth 3 / overlap_rebin against the same
    JAX run, and bitwise against the port's serialized / off."""
    ref = _ref_run(jax_dd_reference, "signal_")
    run = _port_dd_run(backend="signal", pipeline="double_buffer",
                       pipeline_depth=3, overlap_rebin=True)
    s, eng, _state, m, d, pos = run
    assert (eng.pipeline.mode, eng.pipeline.depth) == ("double_buffer", 3)
    ref_d = [dict(zip(DIAG_KEYS, row)) for row in ref["diags"]]
    _assert_trajectories_agree(m, d, pos, ref, ref_d, ref["pos"], s.box[0])
    assert np.abs(m["mom"] - ref["mom"]).max() < 1e-9
    _assert_runs_bitwise(run, _port_dd_run(backend="serialized"))


@pytest.mark.parametrize("nstprune", [0, 4])
def test_pruned_f64_2x2x2_matches_jax_sparse(jax_dd_reference, nstprune):
    """The port's ``"pallas"`` force backend (its kernels' plain forms on
    the CPU) against JAX's ``"sparse"`` backend on 8 devices."""
    ref = _ref_run(jax_dd_reference, f"sparse{nstprune}_")
    s, eng, _state, m, d, pos = _port_dd_run(force_backend="pallas",
                                             nstprune=nstprune)
    ref_d = [dict(zip(DIAG_KEYS, row)) for row in ref["diags"]]
    _assert_trajectories_agree(m, d, pos, ref, ref_d, ref["pos"], s.box[0])
    assert np.abs(m["mom"] - ref["mom"]).max() < 1e-9
    assert eng.sched_history == [tuple(r) for r in ref["sched_history"]]


@pytest.mark.parametrize("nstprune", [0, 4])
def test_pruned_signal_double_buffer_equals_off_bitwise(nstprune):
    """Pruned signal / double_buffer / overlap_rebin against the port's
    pruned off, bitwise (on jax 0.9 the reference's own sparse off and
    double_buffer runs differ, so JAX is no bitwise oracle here)."""
    off = _port_dd_run(force_backend="pallas", nstprune=nstprune)
    for depth in (2, 3):
        _assert_runs_bitwise(_port_dd_run(
            backend="signal", force_backend="pallas", nstprune=nstprune,
            pipeline="double_buffer", pipeline_depth=depth,
            overlap_rebin=True), off)
