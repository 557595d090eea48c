"""SimServer: continuous batching of many independent MD replicas.

The port of the JAX package's ``serve/sim_server.py``.  Each bucketed
``(n_rows, n_atoms)`` shape is one lane-stacked table on the card, block
tensors ``(n_rows, Dz, Dy, Dx, cz, cy, cx, K, F)``, run by the batch
programs :meth:`MDEngine.lane_programs` gives: one launch of each kernel
serves every lane, the Hopper form of the reference's vmapped block
program.  Replicas are admitted into free rows (a row written in place)
and retired from finished ones at block boundaries.

Isolation is bitwise, not approximate: a lane's trajectory equals a solo
:class:`~repro_torch.core.md.engine.MDEngine` run of the same replica
(same seed, same bucket box, ``layout_atoms`` of the bucket and, on the
pruned backends, ``static_ladder``) element for element, whatever its
co-residents, admission order or neighbours' retirement.  As in the
reference three things make that hold:

* every replica of an atom bucket shares the bucket's canonical box
  (``make_grappa_like(n, box_atoms=bucket)``) and hence its cell layout;
* the pruned backends run the static worst-case tier ladder, one ``(M,
  K)`` tier for every lane and block, so no lane's data reaches another
  lane's shapes, and empty rows are physics-inert;
* each cycle runs a solo run's order, retire -> admit -> rebin
  (+ prune) -> block -> quarantine -> retire, with retirement reads after
  the block, where a solo run's final state also sits.

Faults are per lane: the template engines' ``health`` monitor (bitwise
neutral) gives each lane's per-step non-finite counts, read once a block
as one ``(n_rows,)`` vector; a poisoned lane is retired with a typed
:class:`ReplicaFault` while its co-residents run on untouched.  Block
deadlines use :class:`~repro_torch.resilience.WaveTimeout` /
:class:`~repro_torch.resilience.Watchdog`, and the replica-step accounting
the LM server's ``masked_tokens``.

Two deliberate differences from the reference:

* ``serve/compiles`` counts the bucket shapes whose batch programs were
  built (the reference counts traces, one per shape), so ``compiles ==
  len(shapes_touched)`` holds alike; :meth:`SimServer.stats` also reports
  the step graphs each shape captured (``captures_by_shape``), which must
  not grow with churn once a shape is warm.  Each shape keeps its own
  :class:`~repro_torch.core.pipeline.block_graph.BlockGraphs`, so churn
  across shapes never evicts another shape's graphs.
* The reference's 4-axis ``('rep', z, y, x)`` mesh, which shards replica
  rows over devices, is multi-GPU work: the port raises on it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import cells_to_domains
from repro_torch.core.md.domain import AXES
from repro_torch.core.md.engine import MDEngine
from repro_torch.core.md.pair_schedule import SLOT_QUANTUM
from repro_torch.core.md.schedule_opt import tier_plan
from repro_torch.core.md.system import MDSystem, make_grappa_like
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.obs import MetricsRegistry, block_until_ready
from repro_torch.resilience.faults import ResilienceError, WaveTimeout
from repro_torch.resilience.policy import Watchdog
from repro_torch.runtime.serve_loop import masked_tokens
from repro_torch.serve.buckets import BucketLadder
from repro_torch.serve.scheduler import (
    DONE, FAILED, PREEMPTED, SimScheduler, TERMINAL)

__all__ = ["SimServer", "ReplicaHandle", "ReplicaFault"]


class ReplicaFault(ResilienceError):
    """A replica's trajectory went non-finite inside a batch.

    Raised to the owning handle only: the lane is quarantined and
    retired at the block boundary; co-resident replicas in the same
    bucket keep running bitwise unchanged.
    """


@dataclasses.dataclass
class _Programs:
    """The batch programs of one shape (kept across reopens)."""

    lanes: dict                        # MDEngine.lane_programs
    tiers: Optional[tuple]             # the static ladder; None dense


@dataclasses.dataclass
class _Runtime:
    """Live device state of one open table."""

    shape: Tuple[int, int]
    cell_f: torch.Tensor               # (R, Dz, Dy, Dx, cz, cy, cx, K, 7)
    cell_i: torch.Tensor               # (R, Dz, Dy, Dx, cz, cy, cx, K, 2)


class ReplicaHandle:
    """Client view of one submitted replica: poll / result / cancel."""

    def __init__(self, server: "SimServer", rid: int):
        self._server = server
        self.rid = rid

    @property
    def status(self) -> str:
        return self._server.scheduler.records[self.rid].status

    def poll(self) -> dict:
        rec = self._server.scheduler.records[self.rid]
        return {"status": rec.status, "steps_done": rec.steps_done,
                "budget_steps": rec.budget_steps,
                "requested_steps": rec.requested_steps,
                "shape": rec.shape, "row": rec.row}

    def result(self, wait: bool = True) -> Optional[dict]:
        """The replica's read-out state.  Blocks (serving other replicas
        too) until this replica is terminal when ``wait``.  Raises the
        quarantine error for a FAILED replica; returns ``None`` for one
        cancelled before admission."""
        if wait:
            self._server.drain(until=self.rid)
        rec = self._server.scheduler.records[self.rid]
        if rec.status not in TERMINAL:
            raise RuntimeError(
                f"replica {self.rid} still {rec.status}; pass wait=True")
        if rec.status == FAILED:
            raise rec.error
        return self._server._results.get(self.rid)

    def cancel(self) -> str:
        return self._server.scheduler.cancel(self.rid)


class SimServer:
    """Continuous-batching server over bucketed lane-stacked MD programs.

    ``mesh`` is the engine's ``(z, y, x)`` virtual domain mesh (every
    replica's domains on one card).  ``engine_kwargs`` pass through to the
    per-atom-bucket template engines (``spec``, ``force_backend``,
    ``pipeline``, ...); ``system_kwargs`` to the canonical bucket systems
    (density, cutoff, ...): submitted replicas must share the bucket box,
    i.e. be built with ``box_atoms=<atom bucket>`` and the same
    ``nstlist``.  ``device`` defaults to ``"cuda"`` and raises without
    CUDA.
    """

    def __init__(self, mesh=None, ladder: Optional[BucketLadder] = None,
                 *, block_steps: int = 10,
                 engine_kwargs: Optional[dict] = None,
                 system_kwargs: Optional[dict] = None,
                 wave_timeout_s: Optional[float] = None,
                 watchdog: Optional[Watchdog] = None,
                 obs: Optional[MetricsRegistry] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh((1, 1, 1), AXES)
        names = tuple(self.mesh.axis_names)
        if len(names) == 4 and names[1:] == AXES:
            raise NotImplementedError(
                f"mesh axes {names}: a leading replica axis shards rows "
                "over devices, which is multi-GPU work outside the "
                "single-card port; pass the (z, y, x) mesh")
        if names != AXES:
            raise ValueError(
                f"mesh axes must be {AXES}; got {names}")
        self.axis_sizes = tuple(self.mesh.shape[a] for a in AXES)
        self.ladder = ladder or BucketLadder()
        self.block_steps = int(block_steps)
        self.scheduler = SimScheduler(self.ladder, self.block_steps)
        self.engine_kwargs = dict(engine_kwargs or {})
        for k in ("layout_atoms", "health", "static_ladder", "nstprune",
                  "device"):
            if k in self.engine_kwargs:
                raise ValueError(f"engine_kwargs[{k!r}] is server-managed")
        self.system_kwargs = dict(system_kwargs or {})
        self.wave_timeout_s = wave_timeout_s
        self.watchdog = watchdog
        # a private registry by default: serve counters (the compile-count
        # contract above all) must not alias across servers in one
        # process; pass obs=default_registry() to publish globally
        self.obs = obs if obs is not None else MetricsRegistry()
        self._templates: Dict[int, MDEngine] = {}
        self._programs: Dict[Tuple[int, int], _Programs] = {}
        self._runtimes: Dict[Tuple[int, int], _Runtime] = {}
        self._pending_rows: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._handles: Dict[int, ReplicaHandle] = {}
        self._results: Dict[int, dict] = {}
        self._blocks = 0
        self._serve_wall_s = 0.0
        self._step_walls: List[float] = []

    # ---- templates & programs ---------------------------------------------

    def _template(self, atoms: int) -> MDEngine:
        """Per-atom-bucket template engine: owns the canonical box, cell
        layout and step physics every lane of the bucket reuses.  It never
        runs a solo simulation."""
        if atoms not in self._templates:
            sys_kw = dict(self.system_kwargs)
            sys_kw.setdefault("nstlist", self.block_steps)
            if sys_kw["nstlist"] != self.block_steps:
                raise ValueError("system nstlist must equal block_steps")
            tmpl_sys = make_grappa_like(atoms, seed=0, **sys_kw)
            kw = dict(self.engine_kwargs)
            fb = kw.get("force_backend", "dense")
            self._templates[atoms] = MDEngine(
                tmpl_sys, self.mesh, health=True,
                static_ladder=(fb != "dense"), device=self.device, **kw)
        return self._templates[atoms]

    def _block_shape(self, tmpl: MDEngine, feats: int) -> tuple:
        """One replica's block-tensor shape under ``tmpl``'s layout."""
        return (self.axis_sizes + tuple(tmpl.layout.cells_per_domain)
                + (tmpl.layout.capacity, feats))

    def _build_programs(self, shape: Tuple[int, int]) -> _Programs:
        if shape in self._programs:
            return self._programs[shape]
        rows, atoms = shape
        tmpl = self._template(atoms)
        tiers = None
        if tmpl.force_backend != "dense":
            M = tmpl.pair_schedule.n_pairs
            L = tmpl.pair_schedule.levels
            K = tmpl.layout.capacity
            # static worst-case ladder: every lane, every block runs the
            # same (M, K) tier (data-independent shapes, inert sentinels)
            tiers = tier_plan([M] * L, tmpl.pair_bucket, M, SLOT_QUANTUM, K)
        self._programs[shape] = _Programs(
            lanes=tmpl.lane_programs(rows), tiers=tiers)
        self.obs.counter("serve/compiles").inc()
        return self._programs[shape]

    def _ensure_runtime(self, shape: Tuple[int, int]) -> _Runtime:
        if shape in self._runtimes:
            return self._runtimes[shape]
        rows, atoms = shape
        tmpl = self._template(atoms)
        cf = torch.zeros((rows,) + self._block_shape(tmpl, 7),
                         dtype=tmpl.dtype, device=self.device)
        ci = torch.full((rows,) + self._block_shape(tmpl, 2), -1,
                        dtype=torch.int32, device=self.device)
        self._build_programs(shape)
        self._runtimes[shape] = _Runtime(shape=shape, cell_f=cf, cell_i=ci)
        return self._runtimes[shape]

    # ---- client API --------------------------------------------------------

    def submit(self, system: MDSystem, n_steps: int,
               state: Optional[Tuple[np.ndarray, np.ndarray]] = None
               ) -> ReplicaHandle:
        """Queue a replica for ``n_steps`` (rounded up to whole blocks).

        ``state`` resumes a previously evacuated replica from its block
        arrays (``(Dz, Dy, Dx, cz, cy, cx, K, 7)`` and ``(..., 2)``, as
        :meth:`evacuate` and results give them) instead of binning
        ``system`` fresh."""
        atoms = self.ladder.atom_bucket_for(system.n_atoms)
        tmpl = self._template(atoms)
        if not np.array_equal(np.asarray(system.box),
                              np.asarray(tmpl.system.box)):
            raise ValueError(
                f"replica box {system.box} != bucket-{atoms} box "
                f"{tmpl.system.box}; build replicas with box_atoms={atoms}")
        if system.params.nstlist != self.block_steps:
            raise ValueError(
                f"replica nstlist={system.params.nstlist} != server "
                f"block_steps={self.block_steps}")
        if state is None:
            rows = cells_to_domains(*tmpl.bin_host(system), self.axis_sizes)
        else:
            cf_row, ci_row = state
            want = self._block_shape(tmpl, 7)
            if tuple(np.shape(cf_row)) != want:
                raise ValueError(
                    f"resume state shape {np.shape(cf_row)} does not match "
                    f"bucket-{atoms} blocks {want}")
            rows = (np.asarray(cf_row), np.asarray(ci_row))
        rid = self.scheduler.submit(system.n_atoms, n_steps)
        self._pending_rows[rid] = tuple(np.ascontiguousarray(r)
                                        for r in rows)
        self._handles[rid] = ReplicaHandle(self, rid)
        return self._handles[rid]

    def run_cycle(self) -> bool:
        """One boundary + block round across every live table: retire
        (previous cycle) -> admit -> rebin (+ prune) -> block ->
        quarantine -> retire.  Returns True while work remains."""
        # retire replicas flagged since the last block (client cancels):
        # they must not run another block.  Budget and fault retirements
        # already happened after the block, where the read-out state is a
        # solo run's final state.
        for shape in self.scheduler.live_shapes():
            self._retire_due(shape)
        for adm in self.scheduler.tick():
            rt = self._ensure_runtime(adm.shape)
            cf_row, ci_row = self._pending_rows.pop(adm.rid)
            rt.cell_f[adm.row].copy_(torch.as_tensor(cf_row))
            rt.cell_i[adm.row].copy_(torch.as_tensor(ci_row))
        for shape in self.scheduler.live_shapes():
            self._dispatch_block(shape)
        return self.scheduler.pending() > 0

    def drain(self, until: Optional[int] = None) -> None:
        """Serve until the queue is empty (or replica ``until`` is
        terminal); every cycle makes progress, so this terminates."""
        while self.scheduler.pending() > 0:
            if until is not None and \
                    self.scheduler.records[until].status in TERMINAL:
                return
            self.run_cycle()

    def evacuate(self) -> List[Tuple[ReplicaHandle, dict]]:
        """Retire every resident replica as PREEMPTED, returning their
        portable snapshots (host block arrays + remaining budget) for
        readmission through ``submit(..., state=...)`` on a rebuilt
        server.  Queued replicas stay queued."""
        out = []
        for shape in list(self.scheduler.live_shapes()):
            rt = self._runtimes[shape]
            for row, rid in list(self.scheduler.occupants(shape)):
                rec = self.scheduler.records[rid]
                self._read_out(rt, rec)
                snap = dict(self._results[rid])
                snap["remaining_steps"] = \
                    rec.budget_steps - rec.steps_done
                self.scheduler.release(rid, status=PREEMPTED)
                self._clear_row(rt, row)
                out.append((self._handles[rid], snap))
        return out

    def stats(self) -> dict:
        """Serving summary: throughput, latency percentiles, compiles, and
        the step graphs each shape captured and replayed."""
        walls = np.asarray(self._step_walls, np.float64)
        c = self.obs.counter
        done = c("serve/replicas_done").value
        captures, replays = {}, {}
        for (rows, atoms), progs in sorted(self._programs.items()):
            graphs = progs.lanes["engine"].block_graphs
            if graphs is not None:
                st = graphs.stats()
                captures[f"{rows}x{atoms}"] = st["captures"]
                replays[f"{rows}x{atoms}"] = st["replays"]
        return {
            "replicas_done": done,
            "replicas_failed": c("serve/replicas_failed").value,
            "blocks": self._blocks,
            "compiles": c("serve/compiles").value,
            "shapes_touched": sorted(self.scheduler.shapes_touched),
            "useful_steps": c("serve/useful_steps").value,
            "wall_s": self._serve_wall_s,
            "replicas_per_s": done / max(self._serve_wall_s, 1e-9),
            "step_latency_p50_ms": float(np.percentile(walls, 50) * 1e3)
            if walls.size else 0.0,
            "step_latency_p99_ms": float(np.percentile(walls, 99) * 1e3)
            if walls.size else 0.0,
            "captures_by_shape": captures,
            "replays_by_shape": replays,
        }

    # ---- block dispatch ----------------------------------------------------

    def _dispatch_block(self, shape: Tuple[int, int]) -> None:
        rt = self._runtimes[shape]
        progs = self._programs[shape]
        lanes = progs.lanes
        t0 = time.perf_counter()
        cf, ci, force, _diag = lanes["rebin"](rt.cell_f, rt.cell_i)
        if progs.tiers is not None:
            sel, _cum, _cum_in, _occ = lanes["prune"](cf, ci)
            cf, ci, _fl, metrics, _ovf = lanes["block_sched"](
                cf, ci, force, sel, self.block_steps, progs.tiers, ())
        else:
            cf, ci, _fl, metrics = lanes["block"](cf, ci, force,
                                                  self.block_steps)
        block_until_ready(cf)
        dt = time.perf_counter() - t0
        rt.cell_f, rt.cell_i = cf, ci
        self._blocks += 1
        self._serve_wall_s += dt
        self._step_walls.append(dt / self.block_steps)
        self.obs.counter("serve/blocks").inc()
        self.obs.histogram("serve/block_s").observe(dt)
        self.obs.gauge(f"serve/occupancy/{shape[0]}x{shape[1]}").set(
            self.scheduler.occupancy(shape))
        if self.watchdog is not None:
            self.watchdog.observe(self._blocks - 1, dt)
        if self.wave_timeout_s is not None and dt > self.wave_timeout_s:
            raise WaveTimeout(
                f"bucket {shape[0]}x{shape[1]} block exceeded "
                f"{self.wave_timeout_s:.3f}s ({dt:.3f}s elapsed)")
        self.scheduler.advance(shape)
        # per-lane quarantine: one read of the (rows,) health vector; the
        # monitor is bitwise neutral, so reading it perturbs nothing
        bad = metrics["health/nonfinite"].sum(dim=1).cpu().numpy()
        for row, rid in self.scheduler.occupants(shape):
            if bad[row]:
                self.scheduler.mark_fault(rid, ReplicaFault(
                    f"replica {rid} went non-finite in bucket "
                    f"{shape[0]}x{shape[1]} row {row} "
                    f"({int(bad[row])} bad step-values); lane quarantined"))
        self._retire_due(shape)

    def _retire_due(self, shape: Tuple[int, int]) -> None:
        rt = self._runtimes[shape]
        for rid in self.scheduler.finished(shape):
            rec = self.scheduler.records[rid]
            self._read_out(rt, rec)
            row = rec.row
            rec = self.scheduler.release(rid)
            self._clear_row(rt, row)
            if rec.status == DONE:
                self.obs.counter("serve/replicas_done").inc()
                # the LM server's wave accounting: useful work is the
                # requested budget, not the padded block multiple
                self.obs.counter("serve/useful_steps").inc(masked_tokens(
                    [rec.steps_done], [rec.requested_steps]))
            elif rec.status == FAILED:
                self.obs.counter("serve/replicas_failed").inc()

    def _read_out(self, rt: _Runtime, rec) -> None:
        # copies: on the CPU .cpu() shares the table, which the row's
        # clear overwrites
        cf_row = rt.cell_f[rec.row].cpu().numpy().copy()
        ci_row = rt.cell_i[rec.row].cpu().numpy().copy()
        self._results[rec.rid] = {
            "cell_f": cf_row, "cell_i": ci_row,
            "steps": rec.steps_done,
            "requested_steps": rec.requested_steps,
            "atoms": _export_row(cf_row, ci_row, rec.n_atoms),
        }

    def _clear_row(self, rt: _Runtime, row: int) -> None:
        # a cleared row is physics-inert: no valid ids, zero occupancy;
        # the rebin migrates nothing and the forces see no atoms
        rt.cell_f[row].zero_()
        rt.cell_i[row].fill_(-1)


def _export_row(cf_row: np.ndarray, ci_row: np.ndarray,
                n_atoms: int) -> dict:
    """Per-atom positions / velocities in global-id order for one lane
    (the lane-local analogue of the reference's ``export_atoms``)."""
    ids = ci_row[..., 0].reshape(-1)
    valid = ids >= 0
    pos = np.zeros((n_atoms, 3), cf_row.dtype)
    vel = np.zeros((n_atoms, 3), cf_row.dtype)
    pos[ids[valid]] = cf_row[..., 0:3].reshape(-1, 3)[valid]
    vel[ids[valid]] = cf_row[..., 4:7].reshape(-1, 3)[valid]
    return {"pos": pos, "vel": vel}
