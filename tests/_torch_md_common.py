"""Shared pieces of the port's MD tests against the JAX MDEngine
(``tests/test_torch_md*.py``): engines on either package, the x64 switch
and the trajectory bars.  Import it after ``pytest.importorskip("jax")``.
"""
import contextlib
from pathlib import Path

import jax
import numpy as np

from repro.core.halo_plan import HaloSpec as JaxHaloSpec
from repro.core.md import MDEngine as JaxMDEngine
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro_torch.core.halo_plan import HaloSpec
from repro_torch.core.md import MDEngine
from repro_torch.launch.mesh import make_mesh

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



def _assert_trajectories_agree(m, d, pos, ref_m, ref_d, ref_pos, box):
    for k in ("pe", "ke"):
        rel = np.abs(m[k] - ref_m[k]).max() / np.abs(ref_m[k]).max()
        assert rel < 1e-9, (k, rel)
    assert np.abs(pos - ref_pos).max() / box < 1e-9
    assert _diag_rows(d) == _diag_rows(ref_d)
