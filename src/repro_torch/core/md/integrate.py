"""Velocity-Verlet diagnostics on the virtual mesh.

Arrays carry the three leading domain dims; each function sums a
domain's own atoms first and then across domains (the reference's
``lax.psum``).
"""
from __future__ import annotations

import torch

ND = 3   # leading domain dims (Dz, Dy, Dx)


def kinetic_energy(vel, valid, mass: float):
    v2 = torch.sum(vel * vel, dim=-1)
    masked = torch.where(valid, v2, torch.zeros((), dtype=v2.dtype,
                                                device=v2.device))
    ke_local = 0.5 * mass * torch.sum(masked, dim=tuple(range(ND, v2.dim())))
    return torch.sum(ke_local)


def momentum(vel, valid, mass: float):
    masked = torch.where(valid[..., None], vel,
                         torch.zeros((), dtype=vel.dtype, device=vel.device))
    p_local = mass * torch.sum(masked, dim=tuple(range(ND, vel.dim() - 1)))
    return torch.sum(p_local.reshape(-1, vel.shape[-1]), dim=0)
