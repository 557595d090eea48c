"""Grappa-like benchmark systems: homogeneous LJ + reaction-field fluid.

The paper's evaluation uses the "grappa" set — water/ethanol mixtures from
45k to 46M atoms with reaction-field electrostatics, chosen because their
computational profile matches typical biomolecular runs while staying
homogeneous (paper §6.1).  We reproduce that profile in reduced LJ units:
a dense two-type fluid (water-like / ethanol-like LJ parameters) carrying
small alternating partial charges, reaction-field electrostatics with a
potential shift, and a van-der-Waals potential-shift at the cutoff.

Numpy only, a copy of the JAX package's builder: for a seed it yields
the identical arrays, so both packages start from the same state.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ForceField:
    """Pairwise LJ (per type pair, Lorentz-Berthelot) + reaction field."""

    eps: Tuple[Tuple[float, ...], ...]      # (T, T) LJ epsilon table
    sigma: Tuple[Tuple[float, ...], ...]    # (T, T) LJ sigma table
    r_cut: float
    eps_rf: float                           # RF dielectric (inf -> k_rf=1/(2rc^3))

    @property
    def k_rf(self) -> float:
        if np.isinf(self.eps_rf):
            return 1.0 / (2.0 * self.r_cut ** 3)
        e = self.eps_rf
        return (e - 1.0) / (2.0 * e + 1.0) / self.r_cut ** 3

    @property
    def c_rf(self) -> float:
        """Potential shift making the RF term vanish at the cutoff."""
        return 1.0 / self.r_cut + self.k_rf * self.r_cut ** 2


@dataclasses.dataclass(frozen=True)
class MDParams:
    ff: ForceField
    dt: float = 0.002
    mass: float = 1.0
    nstlist: int = 20          # rebin/migration cadence (pair-list horizon)
    temperature: float = 1.0


@dataclasses.dataclass
class MDSystem:
    """Global (pre-decomposition) description of one benchmark system."""

    box: np.ndarray            # (3,) box lengths
    pos: np.ndarray            # (N, 3) float
    vel: np.ndarray            # (N, 3) float
    charge: np.ndarray         # (N,)
    typ: np.ndarray            # (N,) int8
    params: MDParams

    @property
    def n_atoms(self) -> int:
        return self.pos.shape[0]


DEFAULT_FF = ForceField(
    eps=((1.0, 0.9), (0.9, 0.8)),
    sigma=((1.0, 1.05), (1.05, 1.1)),
    r_cut=2.5,
    eps_rf=float("inf"),
)


def make_grappa_like(n_atoms: int, density: float = 0.78,
                     temperature: float = 1.0, charge_mag: float = 0.25,
                     ethanol_fraction: float = 0.2, seed: int = 0,
                     dtype=np.float32, ff: ForceField = DEFAULT_FF,
                     dt: float = 0.002, nstlist: int = 20,
                     box_atoms: int | None = None) -> MDSystem:
    """Build a charge-neutral two-type fluid on a jittered FCC-ish lattice.

    Lattice start avoids overlaps (stable from step 0); velocities are
    Maxwell-Boltzmann with the center-of-mass motion removed, as GROMACS
    does at generation time.

    ``box_atoms`` sizes the box as if the system held that many atoms (at
    the same density), while only ``n_atoms`` are actually placed — the
    SimServer bucket contract: every replica of an ``n_atoms_bucket``
    shares the bucket's canonical box (hence cell layout), and sub-bucket
    replicas simply run more dilute.
    """
    rng = np.random.RandomState(seed)
    # cubic box from density (host numbers: no tensor)
    L = ((box_atoms or n_atoms) / density) ** (1.0 / 3.0)  # noqa: RT005
    box = np.array([L, L, L], dtype=np.float64)

    # simple-cubic lattice with jitter, then trim to n_atoms
    per_dim = int(np.ceil(n_atoms ** (1 / 3)))
    spacing = L / per_dim
    grid = np.stack(np.meshgrid(*[np.arange(per_dim)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3).astype(np.float64)
    pos = (grid + 0.5) * spacing
    order = rng.permutation(pos.shape[0])[:n_atoms]
    pos = pos[order]
    pos += rng.uniform(-0.08, 0.08, pos.shape) * spacing
    pos %= box

    # velocities ~ Maxwell(T), zero total momentum
    vel = rng.normal(0.0, np.sqrt(temperature), (n_atoms, 3))
    vel -= vel.mean(axis=0, keepdims=True)

    # alternating charges in pairs -> exactly neutral
    charge = np.zeros(n_atoms)
    half = n_atoms // 2
    charge[:half] = charge_mag
    charge[half:2 * half] = -charge_mag
    rng.shuffle(charge)

    typ = (rng.uniform(size=n_atoms) < ethanol_fraction).astype(np.int8)

    params = MDParams(ff=ff, dt=dt, nstlist=nstlist, temperature=temperature)
    if ff.r_cut >= L / 2:
        raise ValueError(
            f"r_cut={ff.r_cut} must be < box/2={L / 2:.3f} "
            f"(n_atoms={n_atoms} too small for this density/cutoff)")
    return MDSystem(box=box, pos=pos.astype(dtype), vel=vel.astype(dtype),
                    charge=charge.astype(dtype), typ=typ, params=params)


# the paper's grappa ladder (§6.1): 45k .. 2.88M atoms as used in Figs. 3-8
GRAPPA_SIZES = {
    "grappa-45k": 45_000,
    "grappa-90k": 90_000,
    "grappa-180k": 180_000,
    "grappa-360k": 360_000,
    "grappa-720k": 720_000,
    "grappa-1440k": 1_440_000,
    "grappa-2880k": 2_880_000,
}
