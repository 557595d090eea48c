"""Bucketed batch shapes for the SimServer.

The port of the JAX package's ``serve/buckets.py`` (a copy).

A *bucket* is a compiled batch shape ``(n_rows, n_atoms)``: a vmapped MD
block program over ``n_rows`` replica lanes, each lane sized for the
bucket's canonical ``n_atoms`` box.  The ladder quantises both axes the
way aphrodite-engine's ``_BATCH_SIZES_TO_CAPTURE`` quantises CUDA-graph
batch sizes: admission picks the smallest rung that fits, so the set of
shapes ever compiled is bounded by ``len(row_buckets) *
len(atom_buckets)`` no matter how replicas churn.

The atom rung fixes the *box* (every replica of an atom bucket is built
with ``make_grappa_like(n, box_atoms=bucket)`` and therefore shares the
bucket's cell layout bitwise); the row rung fixes the vmap width.  Row
choice is padding-waste-aware: a table opens with the smallest rung
covering the queue at that instant rather than the deepest one, so two
queued replicas never pay for a 16-lane program.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

DEFAULT_ROW_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8, 16)
DEFAULT_ATOM_BUCKETS: Tuple[int, ...] = (192, 256)


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One compiled batch shape: ``n_rows`` replica lanes of ``n_atoms``."""

    n_rows: int
    n_atoms: int

    @property
    def key(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_atoms)

    def __str__(self) -> str:  # metric/label form: "4x256"
        return f"{self.n_rows}x{self.n_atoms}"


@dataclasses.dataclass(frozen=True)
class BucketLadder:
    """The quantisation grid admission draws shapes from."""

    row_buckets: Tuple[int, ...] = DEFAULT_ROW_BUCKETS
    atom_buckets: Tuple[int, ...] = DEFAULT_ATOM_BUCKETS

    def __post_init__(self):
        for name, rungs in (("row_buckets", self.row_buckets),
                            ("atom_buckets", self.atom_buckets)):
            if not rungs or list(rungs) != sorted(set(rungs)) or \
                    min(rungs) < 1:
                raise ValueError(
                    f"{name} must be ascending, unique, positive: {rungs}")

    @property
    def n_buckets(self) -> int:
        """Upper bound on distinct compiled shapes."""
        return len(self.row_buckets) * len(self.atom_buckets)

    def atom_bucket_for(self, n_atoms: int) -> int:
        """Smallest atom rung holding ``n_atoms`` (the replica's box)."""
        for b in self.atom_buckets:
            if n_atoms <= b:
                return b
        raise ValueError(
            f"replica of {n_atoms} atoms exceeds the largest atom bucket "
            f"{self.atom_buckets[-1]}")

    def rows_for(self, demand: int) -> int:
        """Smallest row rung covering ``demand`` lanes (clamped to the
        deepest rung — excess demand queues rather than widening)."""
        for b in self.row_buckets:
            if demand <= b:
                return b
        return self.row_buckets[-1]

    def bucket_for(self, demand: int, n_atoms: int) -> Bucket:
        return Bucket(self.rows_for(max(demand, 1)),
                      self.atom_bucket_for(n_atoms))


def padding_waste(bucket: Bucket, resident_atoms) -> float:
    """Fraction of the bucket's atom-lane area carrying no physics.

    ``resident_atoms`` are the per-occupied-row replica sizes; empty rows
    count as fully wasted.  The scheduler reports this per live table so
    the occupancy gauge reflects *useful* work, not just filled rows.
    """
    total = bucket.n_rows * bucket.n_atoms
    used = sum(int(a) for a in resident_atoms)
    return 1.0 - used / total if total else 0.0
