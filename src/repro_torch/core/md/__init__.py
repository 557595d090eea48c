"""GROMACS-style MD substrate (the paper's application domain)."""
from repro_torch.core.md.cells import CellLayout, choose_layout
from repro_torch.core.md.engine import MDEngine, RunState
from repro_torch.core.md.forces import compute_forces, direct_forces_reference
from repro_torch.core.md.pair_schedule import (
    PairSchedule,
    force_backends,
    get_force_backend,
    register_force_backend,
)
from repro_torch.core.md.system import (
    DEFAULT_FF,
    GRAPPA_SIZES,
    ForceField,
    MDParams,
    MDSystem,
    make_grappa_like,
)

__all__ = [
    "CellLayout", "choose_layout", "MDEngine", "RunState", "compute_forces",
    "direct_forces_reference", "ForceField", "MDParams", "MDSystem",
    "make_grappa_like", "GRAPPA_SIZES", "DEFAULT_FF", "PairSchedule",
    "force_backends", "get_force_backend", "register_force_backend",
]
