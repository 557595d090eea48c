"""Velocity-Verlet diagnostics on the virtual mesh, and the fixed-order
sum every per-step metric is reduced with.

Arrays carry ``lead`` batch dims (the MD server's replica lanes; none on
a solo run), then the three domain dims; each function sums a domain's
own atoms first and then across domains (the reference's ``lax.psum``),
giving one value per lane.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

ND = 3   # domain dims (Dz, Dy, Dx)
CHUNK = 128


def fixed_sum(x: torch.Tensor, keep: int) -> torch.Tensor:
    """Sum of ``x`` over every dim after the first ``keep``, in an order
    that depends only on the summed size.

    PyTorch picks a reduction's split across threads (or across the
    warps and blocks of a CUDA kernel) from the whole tensor's shape, so
    a plain sum over the same values can round differently in a batch of
    lanes and in a solo run.  Here the summed dims are flattened and
    laid out contiguously and reduced in rounds of rows of at most
    ``CHUNK`` values (:func:`_row`; a tail padded with zeros where no row
    size divides), each round a reduction over a last dim of at most
    ``CHUNK``: on the card one warp adds a row, each thread a fixed
    stride of it (no split across warps or blocks, no vectorized loads,
    at up to 128 values a row), and on the CPU one thread adds a row (a
    row is never split, whatever the thread count); so the order is fixed
    by the row's size alone and a lane's sums equal the solo run's bit
    for bit.
    """
    # contiguous first: a strided view would change the rows' layout,
    # and with it the order
    x = x.contiguous().reshape(tuple(x.shape[:keep]) + (-1,))
    while x.shape[-1] > CHUNK:
        n = x.shape[-1]
        row = _row(n)
        if n % row:
            x = F.pad(x, (0, -n % row))
        x = x.reshape(tuple(x.shape[:-1]) + (-1, row)).sum(-1)
    return x.sum(-1)


def _row(n: int) -> int:
    """The row size of one round over ``n`` values: the largest divisor
    of ``n`` in ``[CHUNK / 4, CHUNK]`` (no padding copy, and a warp never
    idles on a short row), else ``CHUNK``; a function of ``n`` alone."""
    for row in range(CHUNK, CHUNK // 4 - 1, -1):
        if n % row == 0:
            return row
    return CHUNK


def kinetic_energy(vel, valid, mass: float, lead: int = 0):
    v2 = torch.sum(vel * vel, dim=-1)
    masked = torch.where(valid, v2, torch.zeros((), dtype=v2.dtype,
                                                device=v2.device))
    ke_local = 0.5 * mass * fixed_sum(masked, lead + ND)
    return fixed_sum(ke_local, lead)


def momentum(vel, valid, mass: float, lead: int = 0):
    masked = torch.where(valid[..., None], vel,
                         torch.zeros((), dtype=vel.dtype, device=vel.device))
    # the component dim in front of the summed ones
    p_local = mass * fixed_sum(masked.movedim(-1, lead + ND), lead + ND + 1)
    return fixed_sum(p_local.movedim(-1, lead), lead + 1)
