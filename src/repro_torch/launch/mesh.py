"""The virtual domain mesh: a domain grid laid out on one device.

The JAX package shards the ``(z, y, x)`` domain grid over devices; the
port keeps every domain on one card as a leading tensor dimension, so a
mesh here is only its axis names and sizes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple


@dataclass(frozen=True)
class DomainMesh:
    """Axis names -> sizes of a virtual domain grid (one card)."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "axis_sizes",
                           tuple(int(n) for n in self.axis_sizes))
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError("axis_names and axis_sizes must have equal "
                             "length")
        if any(n < 1 for n in self.axis_sizes):
            raise ValueError(f"axis sizes must be >= 1, got "
                             f"{self.axis_sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> DomainMesh:
    return DomainMesh(tuple(axis_names), tuple(shape))


def make_md_mesh(n_domains: int = 1, max_dims: int = 3) -> DomainMesh:
    """Factor a domain count into a (Z, Y, X) DD mesh for MD.

    Same greedy factoring as the JAX package: 8 -> (2,2,2),
    16 -> (4,2,2), 256 -> (8,8,4).  All three axes are always returned
    (sizes may be 1).
    """
    dims = [1] * max_dims
    remaining = int(n_domains)
    if remaining < 1:
        raise ValueError(f"n_domains must be >= 1, got {n_domains}")
    i = 0
    while remaining > 1:
        # peel the smallest prime factor onto the next axis (round robin)
        for f in range(2, remaining + 1):
            if remaining % f == 0:
                dims[i % max_dims] *= f
                remaining //= f
                break
        i += 1
    dims.sort(reverse=True)
    return make_mesh(tuple(dims), ("z", "y", "x"))
