"""The integrator's optional rescale against the JAX package.

``n_atoms_global``, ``temperature`` and ``velocity_rescale`` of
``repro_torch.core.md.integrate`` against the reference's
(``src/repro/core/md/integrate.py``), which sum across domains with
``lax.psum`` and so run inside ``shard_map``:

* one domain: the reference inside ``shard_map`` on a 1x1x1 mesh, the port
  on a (1, 1, 1) virtual mesh, on the same numpy velocities and masks;
* a 2x2x1 virtual mesh with 3 replica lanes (``lead=1``): each lane
  against the reference on a 1x1x1 mesh holding that lane's atoms, all
  domains' cells laid side by side (a sum over every atom either way);

float64 within 1e-12 and float32 within 1e-6 (relative), the atom counts
exact; the velocities outside the mask untouched, bit for bit.  JAX is
imported only inside a fixture (``pytest.importorskip``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.md import integrate

TOL = {np.float64: 1e-12, np.float32: 1e-6}
CELLS, K = (2, 3, 2), 5                 # cells a domain, slots a cell
MASS, TARGET_T, TAU = 1.5, 2.0, 10.0


class Jax:
    """The reference's functions, each jitted inside ``shard_map`` on a
    1x1x1 (z, y, x) mesh."""

    def __init__(self):
        pytest.importorskip("jax")
        import jax
        from jax.sharding import PartitionSpec as P
        from repro.compat import shard_map_norep
        from repro.core.md import integrate as ref
        from repro.launch.mesh import make_mesh
        self.jax, self.ref = jax, ref
        mesh = make_mesh((1, 1, 1), ("z", "y", "x"))

        def on_mesh(fn, n_in):
            return jax.jit(shard_map_norep(fn, mesh=mesh,
                                           in_specs=(P(),) * n_in,
                                           out_specs=P()))

        self.n_atoms = on_mesh(ref.n_atoms_global, 1)
        self.temperature = on_mesh(
            lambda vel, valid: ref.temperature(
                ref.kinetic_energy(vel, valid, MASS),
                ref.n_atoms_global(valid)), 2)
        self.rescale = on_mesh(
            lambda vel, valid: ref.velocity_rescale(vel, valid, MASS,
                                                    TARGET_T, TAU), 2)

    def run(self, vel, valid):
        """(n, T, rescaled velocities) of one domain's arrays, numpy."""
        x64 = vel.dtype == np.float64
        old = self.jax.config.jax_enable_x64
        self.jax.config.update("jax_enable_x64", x64)
        try:
            return (np.asarray(self.n_atoms(valid)),
                    np.asarray(self.temperature(vel, valid)),
                    np.asarray(self.rescale(vel, valid)))
        finally:
            self.jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module")
def jx():
    return Jax()


def _state(lanes, domains, dtype, seed=0):
    """Velocities ``lanes + domains + CELLS + (K, 3)`` and a mask of
    about two thirds of the slots."""
    rng = np.random.RandomState(seed)
    shape = lanes + domains + CELLS + (K,)
    vel = (rng.randn(*shape, 3) * 1.3).astype(dtype)
    valid = rng.rand(*shape) < 0.65
    return vel, valid


def _port(vel, valid, lead):
    v, m = torch.from_numpy(vel), torch.from_numpy(valid)
    n = integrate.n_atoms_global(m, lead)
    T = integrate.temperature(integrate.kinetic_energy(v, m, MASS, lead), n)
    return n, T, integrate.velocity_rescale(v, m, MASS, TARGET_T, TAU, lead)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_one_domain_matches_reference(jx, dtype):
    vel, valid = _state((), (1, 1, 1), dtype)
    want_n, want_T, want_v = jx.run(vel[0, 0, 0], valid[0, 0, 0])
    n, T, v = _port(vel, valid, 0)
    assert n.dtype == torch.int64 and int(n) == int(want_n)
    assert T.dtype == torch.from_numpy(vel).dtype and T.dim() == 0
    assert _rel(T, want_T) <= TOL[dtype]
    assert _rel(v[0, 0, 0], want_v) <= TOL[dtype]
    assert torch.equal(v[~torch.from_numpy(valid)],
                       torch.from_numpy(vel)[~torch.from_numpy(valid)])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_lanes_on_a_2x2x1_mesh_match_reference(jx, dtype):
    vel, valid = _state((3,), (2, 2, 1), dtype, seed=1)
    valid[1] = False                       # an empty lane: T clamps
    n, T, v = _port(vel, valid, 1)
    assert n.shape == T.shape == (3,)
    for r in range(3):
        # the lane's domains side by side along the first cell dim
        lane_v = vel[r].reshape((-1,) + CELLS[1:] + (K, 3))
        lane_m = valid[r].reshape((-1,) + CELLS[1:] + (K,))
        want_n, want_T, want_v = jx.run(lane_v, lane_m)
        assert int(n[r]) == int(want_n)
        np.testing.assert_allclose(float(T[r]), float(want_T),
                                   rtol=TOL[dtype], atol=0)
        got_v = v[r].reshape((-1,) + CELLS[1:] + (K, 3))
        assert _rel(got_v, want_v) <= TOL[dtype]
    assert torch.equal(v[1], torch.from_numpy(vel[1]))


def test_temperature_clamps_an_empty_count():
    ke = torch.tensor(3.0, dtype=torch.float64)
    n = torch.tensor(0)
    assert float(integrate.temperature(ke, n)) == 2.0
    assert float(integrate.temperature(ke, n, dof_per_atom=6)) == 1.0
