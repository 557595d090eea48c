"""SimScheduler: host-side admission/retirement bookkeeping.

The port of the JAX package's ``serve/scheduler.py`` (a copy).  Pure
Python, with no device work, so the admission-churn property suite can drive
thousands of random arrival/retirement sequences without compiling
anything.  The :class:`~repro_torch.serve.sim_server.SimServer` owns the device
arrays and compiled programs; the scheduler owns everything decidable on
the host:

* FIFO queues per atom bucket (submission order is admission order);
* the live *tables* — one per open batch shape, at most one per atom
  bucket — with per-row occupancy;
* padding-waste-aware shape choice (a table opens at the smallest row
  rung covering the queue, via :meth:`BucketLadder.rows_for`);
* per-replica step budgets (rounded up to whole blocks — the block
  program is the admission/retirement quantum) and fault flags;
* the set of shapes ever opened, which the compile-count contract bounds
  by ``ladder.n_buckets``.

Invariants the property suite locks (see ``tests/test_sim_scheduler.py``):
every admitted replica fits its bucket; admission within an atom bucket
is FIFO (no starvation); ``shapes_touched ⊆`` the ladder grid; a
finished/faulted/cancelled replica's row is free again by the next
boundary (`release` precedes the next `tick`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.serve.buckets import Bucket, BucketLadder, padding_waste

# replica lifecycle
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
CANCELLED = "cancelled"
FAILED = "failed"
PREEMPTED = "preempted"      # evacuated (device loss) — resubmittable

TERMINAL = frozenset({DONE, CANCELLED, FAILED, PREEMPTED})


@dataclasses.dataclass
class ReplicaRecord:
    """Everything the host knows about one replica."""

    rid: int
    n_atoms: int
    requested_steps: int
    budget_steps: int               # requested rounded up to whole blocks
    atom_bucket: int
    status: str = QUEUED
    steps_done: int = 0
    shape: Optional[Tuple[int, int]] = None   # (rows, atoms) while RUNNING
    row: Optional[int] = None
    error: Optional[BaseException] = None
    cancel_flag: bool = False
    fault: Optional[BaseException] = None


@dataclasses.dataclass(frozen=True)
class Admission:
    """One row assignment decided at a boundary."""

    shape: Tuple[int, int]
    row: int
    rid: int


class SimScheduler:
    def __init__(self, ladder: Optional[BucketLadder] = None,
                 block_steps: int = 10):
        if block_steps < 1:
            raise ValueError("block_steps must be >= 1")
        self.ladder = ladder or BucketLadder()
        self.block_steps = int(block_steps)
        self.records: Dict[int, ReplicaRecord] = {}
        self.queues: Dict[int, List[int]] = {}        # atom bucket -> rids
        self.tables: Dict[Tuple[int, int], List[Optional[int]]] = {}
        self.shapes_touched: set = set()
        self._next_rid = 0

    # ---- client side -------------------------------------------------------

    def submit(self, n_atoms: int, n_steps: int) -> int:
        """Enqueue a replica; returns its id.  The step budget rounds up
        to a whole number of blocks (the admission quantum)."""
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        atoms = self.ladder.atom_bucket_for(n_atoms)
        blocks = -(-int(n_steps) // self.block_steps)
        rid = self._next_rid
        self._next_rid += 1
        self.records[rid] = ReplicaRecord(
            rid=rid, n_atoms=int(n_atoms), requested_steps=int(n_steps),
            budget_steps=blocks * self.block_steps, atom_bucket=atoms)
        self.queues.setdefault(atoms, []).append(rid)
        return rid

    def cancel(self, rid: int) -> str:
        """Cancel a replica: dequeued immediately while QUEUED, retired
        at the next boundary while RUNNING.  Returns the new status."""
        rec = self.records[rid]
        if rec.status == QUEUED:
            self.queues[rec.atom_bucket].remove(rid)
            rec.status = CANCELLED
        elif rec.status == RUNNING:
            rec.cancel_flag = True
        return rec.status

    # ---- boundary decisions ------------------------------------------------

    def tick(self) -> List[Admission]:
        """One boundary round of admissions, FIFO within each atom
        bucket.  Opens a table (smallest row rung covering the queue)
        for any atom bucket with demand and no live table."""
        out: List[Admission] = []
        for atoms in sorted(self.queues):
            q = self.queues[atoms]
            if not q:
                continue
            shape = self._table_for(atoms)
            if shape is None:
                b = self.ladder.bucket_for(len(q), atoms)
                shape = b.key
                self.tables[shape] = [None] * b.n_rows
                self.shapes_touched.add(shape)
            rows = self.tables[shape]
            for row, occ in enumerate(rows):
                if occ is not None or not q:
                    continue
                rid = q.pop(0)
                rec = self.records[rid]
                rec.status, rec.shape, rec.row = RUNNING, shape, row
                rows[row] = rid
                out.append(Admission(shape=shape, row=row, rid=rid))
        return out

    def _table_for(self, atoms: int) -> Optional[Tuple[int, int]]:
        for shape in self.tables:
            if shape[1] == atoms:
                return shape
        return None

    def live_shapes(self) -> List[Tuple[int, int]]:
        """Shapes with at least one occupied row, in stable order."""
        return [s for s, rows in self.tables.items()
                if any(r is not None for r in rows)]

    def occupants(self, shape: Tuple[int, int]) -> List[Tuple[int, int]]:
        return [(row, rid)
                for row, rid in enumerate(self.tables[shape])
                if rid is not None]

    def occupancy(self, shape: Tuple[int, int]) -> float:
        """Useful fraction of the table's atom-lane area (1 - padding)."""
        resident = [self.records[rid].n_atoms
                    for _, rid in self.occupants(shape)]
        return 1.0 - padding_waste(Bucket(*shape), resident)

    # ---- block accounting --------------------------------------------------

    def advance(self, shape: Tuple[int, int]) -> None:
        """Credit one block of steps to every resident replica."""
        for _, rid in self.occupants(shape):
            self.records[rid].steps_done += self.block_steps

    def mark_fault(self, rid: int, error: BaseException) -> None:
        """Quarantine flag: the replica retires (FAILED) at the next
        boundary; co-residents are untouched."""
        rec = self.records[rid]
        if rec.status == RUNNING and rec.fault is None:
            rec.fault = error

    def finished(self, shape: Tuple[int, int]) -> List[int]:
        """Residents due for retirement at this boundary: budget met,
        cancel requested, or faulted."""
        return [rid for _, rid in self.occupants(shape)
                if self.records[rid].steps_done >=
                self.records[rid].budget_steps
                or self.records[rid].cancel_flag
                or self.records[rid].fault is not None]

    def release(self, rid: int, status: Optional[str] = None,
                error: Optional[BaseException] = None) -> ReplicaRecord:
        """Free the replica's row (its state has been read out).  The
        table closes once empty with an empty queue, so a later burst
        can reopen the atom bucket at a better row rung."""
        rec = self.records[rid]
        if rec.status != RUNNING:
            raise ValueError(f"release of non-running replica {rid} "
                             f"({rec.status})")
        if status is None:
            status = (FAILED if rec.fault is not None
                      else CANCELLED if rec.cancel_flag else DONE)
        rec.status = status
        rec.error = error if error is not None else rec.fault
        rows = self.tables[rec.shape]
        rows[rec.row] = None
        if all(r is None for r in rows) and \
                not self.queues.get(rec.shape[1]):
            del self.tables[rec.shape]
        rec.shape = rec.row = None
        return rec

    # ---- introspection -----------------------------------------------------

    def pending(self) -> int:
        return sum(len(q) for q in self.queues.values()) + \
            sum(1 for rec in self.records.values()
                if rec.status == RUNNING)
