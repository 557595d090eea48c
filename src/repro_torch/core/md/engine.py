"""MD time-stepping on one card over a virtual domain mesh.

The port of the JAX package's ``core/md/engine.py`` with the dense and
the pruned (``"sparse"`` / ``"pallas"``) force backends, the rolling
inner prune, the serialized and the depth-``d`` double-buffered step
pipeline, the fused between-block rebin (``overlap_rebin``) and the
build-time schedule verifier (``verify``).  The step mirrors the
paper's Algorithm 2 (GPU-resident skeleton):

  1. kick-drift                         (velocity Verlet, first half)
  2. coordinate halo exchange           (``plan.fwd_local``)
  3. non-bonded forces, local + halo    (``forces.compute_forces`` or the
                                         pruned pair schedule)
  4. force halo exchange + accumulate   (``plan.rev_local``)
  5. final kick

An ``nstlist`` block of steps runs on the device with no host read; the
rebin / migration runs between blocks.  Every domain of the mesh lives on
the engine's device as a leading tensor dim:

  cell_f (Dz, Dy, Dx, cz, cy, cx, K, 7)  [x, y, z, charge, vx, vy, vz]
  cell_i (Dz, Dy, Dx, cz, cy, cx, K, 2)  [atom id (-1 = empty), type]
  force  (Dz, Dy, Dx, cz, cy, cx, K, 3)  forces at t (the Verlet carry)

With a pruned backend the between-block work also re-prunes the pair
worklist (:func:`pair_schedule.prune_local`) and the host reads its
per-level histograms once per block to size the tier ladders; with
``nstprune`` a block is a chain of sub-blocks, each opened by
:func:`pair_schedule.roll_prune` on the device.  The rebin's force carry
always takes the dense pass, as in the reference.

With ``overlap_rebin`` every block that another block follows also runs
the rebin / migration (and, pruned, the boundary prune) right after its
steps, as one block call; the final block runs plain.  Both paths run
the same operations in the same order, so they are bitwise identical.

``wire_dtype`` compresses the halo payloads (:mod:`repro_torch.core.wire`):
f64 coordinates cross the wire as f32, the force return in the named
format; the plan build rejects a format whose measured drift exceeds the
dense-f32 bound (``verify="warn"`` / ``"off"`` waive it).

``capture="block"`` (the default on CUDA) issues each step's device
work (the step pipeline's serial step, or its ring's prologue, unit per
slot and epilogue) and each between-block rebin and prune as a CUDA
graph (:mod:`repro_torch.core.pipeline.block_graph`): the first two
calls of a function and input shape (a tier ladder) run eagerly, the
third captures, later ones replay, so a block replays its steps from
its fourth on whatever its ladder.  What stays eager is the block's step
context (its atoms' halo indices and tier batches, and with
``nstprune`` each sub-block's rolling prune), and on the host between
blocks the read of the prune's histograms, the rolling prune's overflow
and the migration counters.  ``capture="off"`` (the default on the CPU)
issues every operation eagerly, the port's counterpart of
``jax.disable_jit``; both give the same bits.

The knobs the MD server rests on are the reference's: ``layout_atoms``
sizes the cell layout as if the system held that many atoms (every
replica of a server bucket shares the bucket's layout), ``static_ladder``
runs the pruned backends on the data-independent worst-case tier ladder
(one ``(M, K)`` tier), ``health`` adds the per-step ``health/nonfinite``
count and the per-invocation ``health/led_violation`` flag to the
metrics, ``obs`` is the :class:`~repro_torch.obs.registry.MetricsRegistry`
the engine publishes its records, gauges, counters and spans to, and
``simulate(on_boundary=)`` is the block-boundary hook.  Each is bitwise
neutral.  :meth:`MDEngine.lane_programs` gives the block, rebin and prune
bodies over ``R`` replica lanes, block tensors ``(R, Dz, Dy, Dx, cz, cy,
cx, K, F)``, one launch of each kernel serving every lane: the Hopper
form of the reference's ``jax.vmap(local_programs[...])``.

``trace`` adds the reference's per-step ``obs/*`` ledger counters to the
metrics (host values: the step graphs do not see them).  ``inject`` arms
the fault sites of :mod:`repro_torch.resilience` through
``run_block(fault_vec=, force_overflow=)``: the host decides which sites
fire at each step, so a disarmed step runs (and replays) exactly an
``inject=False`` step.  :meth:`MDEngine.export_atoms`,
:meth:`MDEngine.rebuild` and :meth:`MDEngine.reshard` are the
self-healing runner's elasticity: on one card a lost device becomes a
smaller virtual mesh.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import warnings

import numpy as np
import torch

from repro_torch.analysis.schedule_verifier import gate_md_build
from repro_torch.convert import cells_to_domains
from repro_torch.core.halo_plan import HaloPlan, HaloSpec
from repro_torch.core.md import integrate
from repro_torch.core.md.cells import choose_layout
from repro_torch.core.md.domain import AXES, rebin
from repro_torch.core.md.forces import compute_forces, stencil_pairs
from repro_torch.core.md.pair_schedule import (
    PAIR_BUCKET,
    SLOT_QUANTUM,
    PairSchedule,
    force_backends,
    get_force_backend,
    inner_radius as default_inner_radius,
    prepare_tiers,
    prune_local,
    prune_radius,
    roll_prune,
)
from repro_torch.core.md.schedule_opt import (
    bucket,
    tier_cum,
    tier_plan,
    tier_rows,
)
from repro_torch.core.md.system import MDSystem
from repro_torch.core.pipeline.block_graph import BlockGraphs
from repro_torch.core.pipeline.ledger import (
    DISARMED,
    SCAN_FAULT_SITES,
    LedgerState,
)
from repro_torch.core.pipeline.step_pipeline import (
    PIPELINE_MODES,
    StepFns,
    StepPipeline,
)
from repro_torch.device import const, resolve_device
from repro_torch.launch.mesh import DomainMesh
from repro_torch.obs import default_registry
from repro_torch.obs import span as obs_span
from repro_torch.obs.tracing import PhaseTracer

_TORCH_DTYPE = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}
CAPTURE_MODES = ("block", "off")


@dataclasses.dataclass
class RunState:
    """Live block-loop state of one simulation run.

    :meth:`MDEngine.begin_run` creates it; :meth:`MDEngine.run_block` and
    :meth:`MDEngine.advance_schedule` mutate it in place.
    """

    cell_f: torch.Tensor
    cell_i: torch.Tensor
    force: torch.Tensor       # velocity-Verlet force carry (post-rebin)
    sched: tuple | None       # (sel, tiers, tiers_inner); None = dense
    disable: bool             # next block falls back to the outer ladder
    step: int                 # steps completed so far
    diags: list               # per-rebin migration diagnostics (ints)
    ledger: LedgerState | None = None   # the last block's final ledger


class MDEngine:
    """Binds a system + virtual mesh + HaloSpec into the step programs.

    ``spec`` selects the halo backend and widths; the engine fills in the
    periodic wrap shifts from the box and builds one :class:`HaloPlan`
    used by every step, rebin and force pass.  ``pipeline`` selects the
    multi-step schedule (``"off"`` or ``"double_buffer"``) and
    ``pipeline_depth`` its in-flight window (ring slots, >= 2); every
    (mode, depth) gives bitwise-identical trajectories, as does
    ``overlap_rebin``.  ``verify`` (``"error"`` / ``"warn"`` / ``"off"``)
    is the build-time gate of the schedule verifier and of the wire
    format's drift (``wire_dtype``, or ``spec.wire_dtype``).  ``device``
    defaults to ``"cuda"`` and raises when CUDA is absent.  ``capture``
    (``"block"`` / ``"off"``; None: ``"block"`` on CUDA, ``"off"`` on the
    CPU) issues each block as a CUDA graph or every operation eagerly;
    ``"block"`` on the CPU raises.
    """

    def __init__(self, system: MDSystem, mesh: DomainMesh,
                 spec: HaloSpec | None = None,
                 r_list_factor: float = 1.08, mig_frac: float = 0.125,
                 pipeline: str = "off", pipeline_depth: int = 2,
                 overlap_rebin: bool = False,
                 force_backend: str = "dense",
                 capacity_safety: float = 2.2,
                 nstprune: int = 0,
                 inner_radius: float | None = None,
                 inner_safety: float = 1.5,
                 pair_bucket: int = PAIR_BUCKET,
                 wire_dtype: str | None = None,
                 verify: str = "error",
                 obs=None, trace: bool = False,
                 inject: bool = False, health: bool = False,
                 layout_atoms: int | None = None,
                 static_ladder: bool = False,
                 device="cuda", capture: str | None = None):
        self.device = resolve_device(device)
        on_cuda = self.device.type == "cuda"
        if capture is None:
            capture = "block" if on_cuda else "off"
        if capture not in CAPTURE_MODES:
            raise ValueError(f"unknown capture mode {capture!r}; "
                             f"available: {CAPTURE_MODES}")
        if capture == "block" and not on_cuda:
            raise ValueError("capture='block' needs a CUDA device (a CUDA "
                             "graph per block); the CPU issues eagerly, "
                             "capture='off'")
        if spec is None:
            spec = HaloSpec(axis_names=AXES, widths=(1, 1, 1))
        if spec.axis_names != tuple(AXES):
            raise ValueError(f"MD halo spec must decompose over {AXES}, "
                             f"got {spec.axis_names}")
        if pipeline not in PIPELINE_MODES:
            raise ValueError(f"unknown pipeline mode {pipeline!r}; "
                             f"available: {PIPELINE_MODES}")
        if int(pipeline_depth) < 2:
            raise ValueError("pipeline_depth must be >= 2 (ring slots; "
                             "2 = double-buffered halos)")
        if min(spec.widths) < 1:
            raise ValueError("MD halo widths must be >= 1 (the NB stencil "
                             "consumes one halo cell layer)")
        if force_backend not in force_backends():
            raise ValueError(f"unknown force backend {force_backend!r}; "
                             f"available: {force_backends()}")
        if int(nstprune) < 0:
            raise ValueError("nstprune must be >= 0 (0 disables the "
                             "rolling inner prune)")
        if inject and overlap_rebin:
            raise ValueError(
                "inject=True is incompatible with overlap_rebin: fault "
                "epochs are block-aligned and the fused path would commit "
                "a poisoned block's rebin/migration before the health "
                "scalars are read at the boundary")
        if system.pos.dtype not in _TORCH_DTYPE:
            raise TypeError(f"system dtype {system.pos.dtype} not "
                            "supported: float32 or float64")
        # fault injection (repro_torch.resilience): the host arms a block's
        # sites per step; inject=False runs the exact same steps
        self.inject = bool(inject)
        # rebuild() / reshard() recreate the engine from these; captured
        # before the one-global-cell degrade below, so a rebuilt engine
        # derives its own fallbacks for its (possibly other) layout
        self._init_kwargs = dict(
            spec=spec, r_list_factor=r_list_factor, mig_frac=mig_frac,
            pipeline=pipeline, pipeline_depth=pipeline_depth,
            overlap_rebin=overlap_rebin, force_backend=force_backend,
            capacity_safety=capacity_safety, nstprune=nstprune,
            inner_radius=inner_radius, inner_safety=inner_safety,
            pair_bucket=pair_bucket, wire_dtype=wire_dtype, verify=verify,
            obs=obs, trace=trace, inject=inject, health=health,
            layout_atoms=layout_atoms, static_ladder=static_ladder,
            device=self.device, capture=capture)
        self.system = system
        self.mesh = mesh
        self.pipeline_mode = pipeline
        self.pipeline_depth = int(pipeline_depth)
        self.overlap_rebin = bool(overlap_rebin)
        self.dtype = _TORCH_DTYPE[system.pos.dtype]
        self.health = bool(health)
        # replica lanes in front of the domain dims: none here, one dim of
        # ``lanes`` on the lane view that lane_programs builds
        self.lead = 0
        self.lanes = None
        mesh_shape = tuple(mesh.shape[a] for a in AXES)
        self.axis_sizes = mesh_shape
        r_list = system.params.ff.r_cut * r_list_factor
        # ``layout_atoms`` sizes the cell capacity as if the system held
        # that many atoms: every replica of a server bucket shares the
        # bucket's layout, so a replica's solo run has the exact shapes
        # (and operations) of its lane
        self.layout_atoms = int(layout_atoms) if layout_atoms else None
        self.layout = choose_layout(system.box, mesh_shape, r_list,
                                    self.layout_atoms or system.n_atoms,
                                    safety=capacity_safety)
        if force_backend != "dense" and min(self.layout.global_cells) < 2:
            # a pair schedule cannot tell a halo cell from its own periodic
            # image here; the dense path masks self-image pairs by atom id
            warnings.warn(
                f"layout {self.layout.global_cells} has a single global "
                f"cell along some dim; the {force_backend!r} pair "
                "schedule degrades to the 'dense' force backend",
                RuntimeWarning, stacklevel=2)
            force_backend = "dense"
        self.force_backend = force_backend
        if force_backend == "dense":
            nstprune = 0               # the dual list rides the schedule
        # ``static_ladder``: the pruned backends run a data-independent
        # worst-case tier ladder (every worklist row at the deepest level)
        # instead of the measured histogram's, so the step shapes depend
        # on the layout alone: no lane's data reaches another lane's
        # shapes.  The prune still runs (``sel`` masks dropped pairs with
        # the inert sentinel), so the physics is unchanged.
        self.static_ladder = bool(static_ladder)
        if self.static_ladder and int(nstprune):
            raise ValueError(
                "static_ladder=True is incompatible with nstprune: the "
                "rolling inner prune exists to shrink the measured ladder "
                "the static ladder deliberately ignores")
        self.nstprune = int(nstprune)
        self.inner_safety = float(inner_safety)
        self.pair_bucket = max(int(pair_bucket), 1)
        if self.nstprune:
            self.r_inner = float(
                default_inner_radius(system.params, self.nstprune)
                if inner_radius is None else inner_radius)
            if self.r_inner < system.params.ff.r_cut:
                raise ValueError(
                    f"inner_radius {self.r_inner} < r_cut "
                    f"{system.params.ff.r_cut}: the rolling prune would "
                    "drop interacting pairs outright")
        else:
            self.r_inner = None
        self.mig_cap = max(64, int(self.layout.pool * mig_frac))
        self.pair_schedule = None
        self.r_prune = prune_radius(system.params)
        self._sched_exec = None     # (sel, tiers, tiers_inner) of last prune
        self._inner_overflows = 0   # blocks whose refresh outgrew the ladder
        # per-block (outer_rows, inner_rows) ladder sizes: inner < outer
        # means the rolling prune shrank the evaluated schedule that block
        self.sched_history: list[tuple[int, int]] = []
        if force_backend != "dense":
            self.pair_schedule = PairSchedule.build(self.layout)
            self._pair_stats = self.pair_schedule.slot_pair_stats()
        else:
            n_dense = len(stencil_pairs()) * self.layout.n_local_cells
            self._pair_stats = {
                "n_pairs_dense": n_dense,
                "k_capacity": self.layout.capacity,
                "dense_slot_pairs": n_dense * self.layout.capacity ** 2,
                "evaluated_slot_pairs": n_dense * self.layout.capacity ** 2,
                "prune_ratio": 1.0,
            }
        self._pair_stats["force_backend"] = force_backend
        if spec.wrap_shift is None:
            ws = np.zeros((3, 4), system.pos.dtype)
            for d in range(3):
                ws[d, d] = system.box[d]
            spec = spec.with_wrap_shift(ws)
        # byte accounting: each exchanged cell carries `capacity` slots of
        # 4 floats (x, y, z, charge); the (K, 2) int32 cell_i exchange is
        # reported separately (halo_stats' bytes_index).  ``wire_dtype``
        # compresses the floating payload on the wire (cell_i rides
        # dense); the plan build runs the drift gate with this engine's
        # verify mode
        if wire_dtype is not None:
            spec = dataclasses.replace(spec, wire_dtype=wire_dtype)
        self.wire_dtype = spec.wire_dtype
        self.plan = HaloPlan.build(
            dataclasses.replace(spec, dtype=np.dtype(system.pos.dtype).name,
                                feature_elems=4 * self.layout.capacity),
            mesh, device=self.device, verify=verify)
        # build-time gate: config sanity (nstprune against the block
        # length, list radii, pool / capacity factors) plus a static replay
        # of the comm schedule every block will emit; unsafe configs are
        # rejected here with a counterexample trace
        self.schedule_report = gate_md_build(
            nstlist=int(system.params.nstlist), nstprune=self.nstprune,
            pipeline=self.pipeline_mode,
            pipeline_depth=self.pipeline_depth,
            overlap_rebin=self.overlap_rebin,
            force_backend=self.force_backend,
            n_pulses=max(1, self.plan.sched.total_pulses), verify=verify,
            inner_safety=self.inner_safety, r_list_factor=r_list_factor,
            mig_frac=mig_frac, capacity_safety=capacity_safety)
        # observability: the stats surfaces also publish records and
        # instruments here (host bookkeeping: the steps are unchanged)
        self.obs = obs if obs is not None else default_registry()
        self.tracer = PhaseTracer(enabled=bool(trace))
        self.obs.emit(
            "engine_build", backend=self.backend,
            pipeline=self.pipeline_mode, pipeline_depth=self.pipeline_depth,
            overlap_rebin=self.overlap_rebin,
            force_backend=self.force_backend, nstprune=self.nstprune,
            n_atoms=system.n_atoms, global_cells=self.layout.global_cells,
            capacity=self.layout.capacity,
            schedule_safe=(None if self.schedule_report is None
                           else self.schedule_report.safe))
        self.capture = capture
        # the graphs' cache; a key's leading part is this engine's
        # configuration (mode, depth, dtype, backend, wire format)
        self.block_graphs = BlockGraphs(self.device) \
            if capture == "block" else None
        self._graph_key = (self.pipeline_mode, self.pipeline_depth,
                           self.dtype, self.backend, self.wire_dtype)
        # verify="off": the engine's gate verified a superset (block length,
        # nstprune sub-blocks, rebin fusion) of the pipeline's own probe
        self.pipeline = StepPipeline.build(self.plan, self._make_step_fns(),
                                           mode=self.pipeline_mode,
                                           depth=self.pipeline_depth,
                                           verify="off",
                                           graphs=self.block_graphs,
                                           graph_key=self._graph_key,
                                           tracer=self.tracer,
                                           inject=self.inject)

    @property
    def spec(self) -> HaloSpec:
        return self.plan.spec

    @property
    def backend(self) -> str:
        return self.plan.spec.backend

    def halo_stats(self) -> dict:
        """Plan-reported bytes / critical-path stats at this DD layout,
        plus the ``cell_i`` index bytes and occupancy-adjusted bytes."""
        K = self.layout.capacity
        gz, gy, gx = self.layout.global_cells
        occupancy = self.system.n_atoms / float(gz * gy * gx * K)
        return self.plan.publish_stats(self.obs,
                                       self.layout.cells_per_domain,
                                       index_elems=2 * K, index_itemsize=4,
                                       occupancy=occupancy,
                                       pipeline=self.pipeline_mode,
                                       depth=self.pipeline_depth)

    def pair_stats(self) -> dict:
        """Evaluated-slot-pair accounting of the latest pruned block, per
        domain per step; ``prune_ratio`` is the dense-over-evaluated work
        reduction (1.0 for the dense backend)."""
        out = dict(self._pair_stats)
        if self.nstprune:
            # the live counter: a final block's overflow has no further
            # rebin to record it in the snapshot above
            out["inner_overflow_blocks"] = self._inner_overflows
        if self.force_backend == "pallas":
            # the reference reports whether its kernel fell back to the
            # jnp twin; the port has no fallback (a CUDA tensor launches
            # the kernel or raises), so the flag is always False
            out["pallas_fallback"] = False
        self.obs.emit("pair_stats", data=out)
        self.obs.gauge("md/prune_ratio").set(out.get("prune_ratio", 1.0))
        return out

    def overlap_stats(self) -> dict:
        """Per-step overlap model at this engine's pipeline mode / depth."""
        overlap = self.plan.stats(self.layout.cells_per_domain,
                                  pipeline=self.pipeline_mode,
                                  depth=self.pipeline_depth)["overlap"]
        self.obs.emit("overlap_model", backend=self.backend, data=overlap)
        return overlap

    # ---- lanes: the domain dims sit after ``self.lead`` lane dims -------

    def _psum(self, x):
        """Sum over the domain dims: one value per lane (the reference's
        ``lax.psum`` over the mesh axes), in a fixed order."""
        return integrate.fixed_sum(x, self.lead)

    def _pmax(self, x):
        """Max over the domain dims (``lax.pmax``)."""
        return torch.amax(x, dim=tuple(range(self.lead, self.lead + 3)))

    # ---- the force pass --------------------------------------------------

    def _trim_ext(self, ext):
        """First halo cell layer of extended blocks (the NB stencil reaches
        exactly one cell); identity at the default widths."""
        if max(self.spec.widths) == 1:
            return ext
        n = self.layout.cells_per_domain
        return ext[(slice(None),) * (self.lead + 3)
                   + tuple(slice(0, n[d] + 1) for d in range(3))]

    def _pad_force(self, F_trim, ext_shape):
        """Zero-pad trimmed forces back to the full extended blocks."""
        if max(self.spec.widths) == 1:
            return F_trim
        n = self.layout.cells_per_domain
        L = self.lead + 3
        F = torch.zeros(tuple(ext_shape[:L + 3]) + F_trim.shape[L + 3:],
                        dtype=F_trim.dtype, device=F_trim.device)
        F[(slice(None),) * L
          + tuple(slice(0, n[d] + 1) for d in range(3))] = F_trim
        return F

    def _force_pass(self, cell_f, cell_i):
        """Dense force pass on block tensors: coordinate halo -> forces ->
        force halo (paper Alg. 3/6); returns (forces, total PE)."""
        ext_f = self.plan.fwd_local(cell_f[..., :4])
        ext_i = self.plan.fwd_local(cell_i, wrap_shift=None)
        F_trim, pe = compute_forces(self._trim_ext(ext_f),
                                    self._trim_ext(ext_i), self.layout,
                                    self.system.params.ff)
        f_local = self.plan.rev_local(self._pad_force(F_trim, ext_f.shape))
        return f_local, self._psum(pe)

    def _force_pass_sched(self, cell_f, cell_i, sel, tiers):
        """Schedule-driven force pass (pruned backends)."""
        ext_f = self.plan.fwd_local(cell_f[..., :4])
        ext_i = self._trim_ext(self.plan.fwd_local(cell_i, wrap_shift=None))
        batches = prepare_tiers(self.pair_schedule, ext_i,
                                sel[..., :tier_rows(tiers)], tiers)
        F_trim, pe = get_force_backend(self.force_backend)(
            self._trim_ext(ext_f), ext_i, self.layout, self.system.params.ff,
            sched=self.pair_schedule, batches=batches)
        f_local = self.plan.rev_local(self._pad_force(F_trim, ext_f.shape))
        return f_local, self._psum(pe)

    def force_fn(self, cell_f, cell_i):
        """One force pass (halo fwd -> NB -> halo rev) on block tensors,
        through the engine's force backend; the pruned backends use the
        schedule of the latest rebin (a fresh prune when none exists)."""
        if self.force_backend == "dense":
            return self._force_pass(cell_f, cell_i)
        if self._sched_exec is None:
            self._refresh_schedule(cell_f, cell_i)
        sel, tiers, _tiers_inner = self._sched_exec
        return self._force_pass_sched(cell_f, cell_i, sel, tiers)

    # ---- step physics, split at the halo seams (StepFns) ---------------

    def _make_step_fns(self) -> StepFns:
        params = self.system.params
        mass = params.mass
        layout, ff = self.layout, params.ff
        dtype, dev = self.dtype, self.device
        lead, health = self.lead, self.health
        half_dt_m = torch.tensor(params.dt / (2 * mass), dtype=dtype,
                                 device=dev)
        dt = torch.tensor(params.dt, dtype=dtype, device=dev)
        zero = torch.zeros((), dtype=dtype, device=dev)

        def begin(cell_f, force, ctx):
            vmask = (ctx["cell_i"][..., 0] >= 0)[..., None]
            # velocity Verlet: kick-drift
            vel_half = cell_f[..., 4:7] + torch.where(
                vmask, force * half_dt_m, zero)
            pos_new = cell_f[..., :3] + torch.where(vmask, vel_half * dt,
                                                    zero)
            cell_f = cell_f.clone()
            cell_f[..., :3] = pos_new
            return cell_f, vel_half, cell_f[..., :4]

        backend_fn = get_force_backend(self.force_backend)
        sched = self.pair_schedule

        def force(ext_f, ctx):
            if "batches" in ctx:           # pruned: the block's tier batches
                F_trim, pe = backend_fn(self._trim_ext(ext_f),
                                        ctx["ext_i_trim"], layout, ff,
                                        sched=sched, batches=ctx["batches"])
            else:
                F_trim, pe = compute_forces(self._trim_ext(ext_f),
                                            ctx["ext_i_trim"], layout, ff)
            return self._pad_force(F_trim, ext_f.shape), {"pe": pe}

        def finish(cell_f, vel_half, f_new, ctx):
            valid = ctx["cell_i"][..., 0] >= 0
            vmask = valid[..., None]
            f_new = torch.where(vmask, f_new, zero)
            # kick; the where between the product and the sum keeps the
            # rounding the same as the reference's
            vel_new = vel_half + torch.where(vmask, f_new * half_dt_m, zero)
            cell_f = cell_f.clone()
            cell_f[..., 4:7] = torch.where(vmask, vel_new, zero)
            raw = {"vel": vel_new, "valid": valid}
            if health:
                raw.update(cell_f_new=cell_f, f_new=f_new)
            return cell_f, f_new, raw

        def count_bad(x):
            bad = ~torch.isfinite(x)
            return torch.sum(bad.reshape(bad.shape[:lead] + (-1,)),
                             dim=lead, dtype=torch.int32)

        def reduce(raw):
            # the step's metrics: no later step waits for them
            out = {}
            if "pe" in raw:
                out["pe"] = self._psum(raw["pe"])
            if "vel" in raw:
                vel, valid = raw["vel"], raw["valid"]
                out["ke"] = integrate.kinetic_energy(vel, valid, mass, lead)
                out["mom"] = integrate.momentum(
                    torch.where(valid[..., None], vel, zero), valid, mass,
                    lead)
            if "f_new" in raw:
                # the in-step NaN / Inf monitor over the state after the
                # kick and the returned forces: an observer, the
                # trajectory is unchanged
                out["health/nonfinite"] = (count_bad(raw["cell_f_new"])
                                           + count_bad(raw["f_new"]))
            return out

        return StepFns(begin=begin, force=force, finish=finish,
                       reduce=reduce)

    def _block_ctx(self, cell_i):
        return {"cell_i": cell_i,
                "ext_i_trim": self._trim_ext(
                    self.plan.fwd_local(cell_i, wrap_shift=None))}

    def _sched_ctx(self, ctx, sel, tiers):
        """``ctx`` plus the tier batches of ``sel``'s first rows: the
        block-constant gathers and scatter index of a (sub-)block."""
        return {**ctx, "batches": prepare_tiers(
            self.pair_schedule, ctx["ext_i_trim"],
            sel[..., :tier_rows(tiers)], tiers)}

    def _run_pipe(self, cell_f, force, n_steps: int, ctx, fv=None):
        """The step pipeline over ``n_steps`` (``fv``: the fault vector of
        an ``inject`` engine, relative to this call), plus with ``health``
        the ledger monitor of the invocation: ``health/led_violation`` is
        1 iff a put-with-signal bookkeeping law broke (a deposit left in
        flight, an acquire before its release, a slot clobbered).  The
        ledger is host bookkeeping, so the flag and the tracer's ``obs/*``
        counters are computed on the host (CPU tensors, one per lane) and
        read nothing from the device."""
        cell_f, f_last, metrics, led = self.pipeline.run_local(
            cell_f, force, n_steps, ctx, fault_vec=fv)
        if self.lead:
            # the host counters are the same for every lane, as under the
            # reference's vmap
            metrics = {k: (v[:, None].expand((n_steps,) + self._lane_shape())
                           .contiguous() if k.startswith("obs/") else v)
                       for k, v in metrics.items()}
        if self.health:
            lg = self.pipeline.ledger
            bad = int(lg.in_flight(led) != 0 or not lg.consistent(led)
                      or not lg.window_safe(led))
            metrics = {**metrics, "health/led_violation": torch.full(
                (1,) + self._lane_shape(), bad, dtype=torch.int32)}
        return cell_f, f_last, metrics, led

    def _lane_shape(self) -> tuple:
        return (self.lanes,) if self.lead else ()

    def block_dense(self, cell_f, cell_i, force, n_steps: int, fv=None):
        """Dense-backend block; returns ``(cell_f, force, metrics, None,
        ledger)``."""
        cell_f, f_last, metrics, led = self._run_pipe(
            cell_f, force, n_steps, self._block_ctx(cell_i), fv)
        return cell_f, f_last, metrics, None, led

    def block_sched(self, cell_f, cell_i, force, sel, n_steps: int, tiers,
                    tiers_inner, fv=None):
        """Pruned-backend block; returns ``(cell_f, force, metrics,
        overflow, ledger)``, the overflow an int32 scalar on the device,
        the ledger that of the last sub-block.

        With an inner ladder the block is a chain of ``nstprune``-step
        sub-blocks (:meth:`sub_block`): each starts with the rolling prune
        (a current-coordinate re-partition of the outer prefix) and runs
        the step pipeline over the inner ladder only.  The overflow counts
        survivors the static ladder could not seat (0 = the inner
        approximation held).
        """
        ctx = self._block_ctx(cell_i)
        zero = torch.zeros(self._lane_shape(), dtype=torch.int32,
                           device=self.device)
        if not tiers_inner:
            cell_f, f_last, metrics, led = self._run_pipe(
                cell_f, force, n_steps, self._sched_ctx(ctx, sel, tiers), fv)
            return cell_f, f_last, metrics, zero, led
        sel_exec = sel[..., :tier_rows(tiers)]
        overflow, f_cur, chunks, done = zero, force, [], 0
        while done < n_steps:
            take = min(self.nstprune, n_steps - done)
            # rebase the block-relative fault steps onto this sub-block's;
            # a site outside it stays disarmed here and fires in its own
            fv_s = None if fv is None else tuple(
                v - done if done <= v < done + take else DISARMED
                for v in fv)
            cell_f, f_cur, m, overflow, sel_exec, led = self.sub_block(
                cell_f, cell_i, ctx["ext_i_trim"], f_cur, sel_exec,
                overflow, take, tiers_inner, fv_s)
            chunks.append(m)
            done += take
        metrics = {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}
        return cell_f, f_cur, metrics, overflow, led

    def sub_block(self, cell_f, cell_i, ext_i_trim, force, sel_exec,
                  overflow, n_steps: int, tiers_inner, fv=None):
        """One rolling-prune sub-block; returns ``(cell_f, force, metrics,
        overflow, sel_exec, ledger)``.  The first sub-block's refresh
        re-derives the partition the boundary prune already saw (same
        coordinates), as the reference does: ``sel`` stays outer-packed,
        so ``force_fn`` and the outer-ladder fallback stay valid on it."""
        budget = const(
            tuple(tier_cum(tiers_inner, SLOT_QUANTUM,
                           self.pair_schedule.levels)),
            torch.int32, self.device)
        ext_f = self.plan.fwd_local(cell_f[..., :4])
        sel_exec, cum_s = roll_prune(
            self.pair_schedule, sel_exec, self._trim_ext(ext_f), ext_i_trim,
            self.r_inner)
        over = torch.clamp(cum_s - budget, min=0)
        overflow = torch.maximum(overflow, torch.amax(
            over.reshape(over.shape[:self.lead] + (-1,)), dim=self.lead))
        ctx = {"cell_i": cell_i, "ext_i_trim": ext_i_trim}
        cell_f, force, m, led = self._run_pipe(
            cell_f, force, n_steps, self._sched_ctx(ctx, sel_exec,
                                                    tiers_inner), fv)
        return cell_f, force, m, overflow, sel_exec, led

    def do_prune(self, cell_f, cell_i):
        """The between-block outer prune; the exec shapes must agree
        across the mesh, so the histograms are the max over domains."""
        ext_f = self.plan.fwd_local(cell_f[..., :4])
        ext_i = self.plan.fwd_local(cell_i, wrap_shift=None)
        sel, cum, cum_inner, occ = prune_local(
            self.pair_schedule, self._trim_ext(ext_f), self._trim_ext(ext_i),
            self.r_prune, r_inner=self.r_inner)
        return (sel, self._pmax(cum), self._pmax(cum_inner), self._pmax(occ))

    def rebin_fn(self, cell_f, cell_i):
        """Wrap, migrate, re-bin, then the force carry for the new bins
        (always the dense pass, as in the reference, whatever the force
        backend)."""
        new_f, new_i, diag = rebin(cell_f, cell_i, self.layout, self.mig_cap,
                                   self.lead)
        force, _pe = self._force_pass(new_f[..., :4], new_i)
        force = torch.where(new_i[..., 0:1] >= 0, force,
                            torch.zeros((), dtype=force.dtype,
                                        device=force.device))
        return new_f, new_i, force, diag

    # ---- replica lanes (the MD server's batch programs) -------------------

    def lane_programs(self, lanes: int) -> dict:
        """The block, rebin and prune bodies over ``lanes`` replica lanes,
        under the reference's names (``"block"``, ``"block_sched"``,
        ``"rebin"``, ``"prune"``): the Hopper form of its
        ``jax.vmap(local_programs[...])``.

        Block tensors are ``(lanes, Dz, Dy, Dx, cz, cy, cx, K, F)``; each
        lane runs this engine's operations on its own block, and one
        launch of each kernel serves every lane (the halo plan's lane
        form, :meth:`HaloPlan.with_lanes`; the pair schedule batches lanes
        as it batches domains), so a lane's trajectory is a solo run's
        bit for bit.  Metrics come out with the lane dim leading, as
        vmap gives them: ``(lanes, n_steps)`` (``mom`` ``(lanes, n_steps,
        3)``), ``health/led_violation`` ``(lanes, 1)``; the rebin's
        diagnostics, the prune's histograms and occupancy and the block's
        overflow are per lane.

        * ``block(cell_f, cell_i, force, n_steps) -> (cell_f, cell_i,
          force, metrics)``;
        * ``block_sched(cell_f, cell_i, force, sel, n_steps, tiers,
          tiers_inner) -> (cell_f, cell_i, force, metrics, overflow)``;
        * ``rebin(cell_f, cell_i) -> (cell_f, cell_i, force, diag)``;
        * ``prune(cell_f, cell_i) -> (sel, cum, cum_inner, occ)``;
        * ``engine``: the lane view of this engine the bodies run on.

        With ``capture="block"`` the step units, rebin and prune run as
        CUDA graphs of the lane view's own
        :class:`~repro_torch.core.pipeline.block_graph.BlockGraphs`, kept
        apart from this engine's (so each lane count keeps its graphs).
        """
        lane = copy.copy(self)
        lane.lead, lane.lanes = 1, int(lanes)
        lane.plan = self.plan.with_lanes(lanes)
        lane.block_graphs = BlockGraphs(self.device) \
            if self.capture == "block" else None
        lane._graph_key = self._graph_key + (("lanes", lane.lanes),)
        lane.pipeline = StepPipeline.build(
            lane.plan, lane._make_step_fns(), mode=self.pipeline_mode,
            depth=self.pipeline_depth, verify="off",
            graphs=lane.block_graphs, graph_key=lane._graph_key,
            tracer=self.tracer, inject=self.inject)

        def lanes_first(m):
            return {k: v.movedim(1, 0) for k, v in m.items()}

        def block(cell_f, cell_i, force, n_steps: int):
            cell_f, f_last, m, _ovf, _led = lane.block_dense(
                cell_f, cell_i, force, n_steps)
            return cell_f, cell_i, f_last, lanes_first(m)

        def block_sched(cell_f, cell_i, force, sel, n_steps: int, tiers,
                        tiers_inner):
            cell_f, f_last, m, ovf, _led = lane.block_sched(
                cell_f, cell_i, force, sel, n_steps, tiers, tiers_inner)
            return cell_f, cell_i, f_last, lanes_first(m), ovf

        return {"block": block, "block_sched": block_sched,
                "rebin": lane._rebin, "prune": lane._prune,
                "engine": lane}

    # ---- state init --------------------------------------------------------

    def bin_host(self, system: MDSystem | None = None):
        """Host-side binning of a system into global numpy cell arrays
        ``(Gz, Gy, Gx, K, F)`` (the reference's stacked layout)."""
        sys, layout = system or self.system, self.layout
        G = layout.global_cells
        K = layout.capacity
        cs = np.asarray(layout.cell_size)
        pos = np.mod(np.asarray(sys.pos, np.float64), sys.box)
        cell3 = np.minimum((pos / cs).astype(np.int64),
                           np.asarray(G) - 1)
        flat = (cell3[:, 0] * G[1] + cell3[:, 1]) * G[2] + cell3[:, 2]
        order = np.argsort(flat, kind="stable")
        sf = flat[order]
        first = np.searchsorted(sf, sf, side="left")
        rank = np.arange(sf.shape[0]) - first
        if np.any(rank >= K):
            raise ValueError("cell capacity overflow at init; raise safety")
        dtype = sys.pos.dtype
        cell_f = np.zeros((G[0], G[1], G[2], K, 7), dtype)
        cell_i = np.full((G[0], G[1], G[2], K, 2), -1, np.int32)
        gz, gy, gx = cell3[order].T
        cell_f[gz, gy, gx, rank, 0:3] = pos[order].astype(dtype)
        cell_f[gz, gy, gx, rank, 3] = np.asarray(sys.charge)[order]
        cell_f[gz, gy, gx, rank, 4:7] = np.asarray(sys.vel)[order]
        cell_i[gz, gy, gx, rank, 0] = np.arange(sys.n_atoms)[order]
        cell_i[gz, gy, gx, rank, 1] = np.asarray(sys.typ)[order]
        return cell_f, cell_i

    def init_state(self):
        """Bin the global system and lay it out as domain blocks on the
        engine's device."""
        cell_f, cell_i = cells_to_domains(*self.bin_host(), self.axis_sizes)
        return (torch.as_tensor(np.ascontiguousarray(cell_f),
                                device=self.device),
                torch.as_tensor(np.ascontiguousarray(cell_i),
                                device=self.device))

    # ---- drivers -----------------------------------------------------------

    @staticmethod
    def _host_diag(diag) -> dict:
        return {k: int(v.item()) for k, v in diag.items()}

    def _refresh_schedule(self, cell_f, cell_i, disable_inner: bool = False):
        """Re-prune the pair worklist for the next block (nstlist cadence),
        right after the rebin; None on the dense backend."""
        if self.force_backend == "dense":
            return None
        sel, cum, cum_inner, occ = self._prune(cell_f, cell_i)
        return self._bucket_exec(sel, cum, cum_inner, occ,
                                 disable_inner=disable_inner)

    def _bucket_exec(self, sel, cum, cum_inner, occ,
                     disable_inner: bool = False):
        """Host half of the prune: read the mesh-global histograms (one
        read per block) and bucket them into the static tier ladders of
        the next block.  ``disable_inner`` is the overflow fallback: one
        block on the outer ladder after a refresh outgrew the inner one."""
        M = self.pair_schedule.n_pairs
        K = self.layout.capacity
        L = cum.shape[0]
        host = torch.cat([cum, cum_inner, occ.reshape(1).to(cum.dtype)]
                         ).tolist()
        cum, cum_inner, occ = host[:L], host[L:2 * L], int(host[2 * L])
        n_keep = cum[0]
        if self.static_ladder:
            # the worst-case histogram: all M rows at the deepest level,
            # one (M, K) tier, the same in every block and every lane
            cum = [M] * len(cum)
        tiers = tier_plan(cum, self.pair_bucket, M, SLOT_QUANTUM, K)
        tiers_inner = ()
        if self.nstprune and not disable_inner:
            # inner ladder: the rebin-time inner histogram, margined for
            # drift until the next rebin, never above the outer one
            cum_in = [min(int(math.ceil(ci * self.inner_safety)), co)
                      for ci, co in zip(cum_inner, cum)]
            tiers_inner = tier_plan(cum_in, self.pair_bucket, M,
                                    SLOT_QUANTUM, K)
        # what one global k_exec rectangle would have evaluated
        global_kexec = bucket(cum[0], self.pair_bucket, M) * \
            bucket(occ, SLOT_QUANTUM, K) ** 2 if cum[0] else 0
        self._pair_stats = self.pair_schedule.slot_pair_stats(
            tiers=tiers, tiers_inner=tiers_inner, n_keep=n_keep,
            n_inner=cum_inner[0], max_occupancy=occ,
            global_kexec_slot_pairs=global_kexec)
        self._pair_stats.update({
            "force_backend": self.force_backend,
            "nstprune": self.nstprune,
            "inner_radius": self.r_inner,
            "inner_overflow_blocks": self._inner_overflows,
            "inner_disabled": bool(self.nstprune and disable_inner),
        })
        outer_rows = tier_rows(tiers)
        inner_rows = tier_rows(tiers_inner) if tiers_inner else outer_rows
        self.sched_history.append((outer_rows, inner_rows))
        self.obs.gauge("md/outer_rows").set(outer_rows)
        self.obs.gauge("md/inner_rows").set(inner_rows)
        self.obs.emit("sched_update", block=len(self.sched_history),
                      outer_rows=outer_rows, inner_rows=inner_rows,
                      max_occupancy=occ,
                      inner_disabled=bool(self.nstprune and disable_inner))
        self._sched_exec = (sel, tiers, tiers_inner)
        return self._sched_exec

    def _note_overflow(self, ovf) -> bool:
        """Record a block's rolling-prune overflow scalar (one read per
        block); True if the next block must use the outer ladder."""
        if not self.nstprune or int(ovf) == 0:
            return False
        self._inner_overflows += 1
        self.obs.counter("md/inner_overflow_blocks").inc()
        if self._inner_overflows == 1:
            warnings.warn(
                "rolling inner prune overflowed its tier ladder (more "
                "survivors than the rebin-time sizing allowed); falling "
                "back to the outer pair list for the next block — raise "
                "inner_safety to avoid this", RuntimeWarning,
                stacklevel=3)
        return True

    def _issue(self, what: str, fn, inputs):
        """``fn(*inputs)`` on the device: eagerly (``capture="off"``), or
        through this engine's graphs, keyed by ``what`` and the inputs'
        shapes."""
        if self.block_graphs is None:
            return fn(*inputs)
        return self.block_graphs.run(what, self._graph_key, fn, inputs)

    def _rebin(self, cell_f, cell_i):
        return self._issue("rebin", self.rebin_fn, (cell_f, cell_i))

    def _prune(self, cell_f, cell_i):
        return self._issue("prune", self.do_prune, (cell_f, cell_i))

    def begin_run(self, state=None, disable_inner: bool = False) -> RunState:
        """Open a block-loop run: bin (or adopt) the state, run the first
        rebin and prune, and return the live :class:`RunState`.
        ``disable_inner=True`` starts the first block on the outer
        ladder."""
        cell_f, cell_i = self.init_state() if state is None else state
        with obs_span("rebin_dispatch", self.obs) as sp:
            cell_f, cell_i, force, diag = self._rebin(cell_f, cell_i)
            sched = self._refresh_schedule(cell_f, cell_i,
                                           disable_inner=disable_inner)
            sp.sync(force)
        return RunState(cell_f, cell_i, force, sched, bool(disable_inner), 0,
                        [self._host_diag(diag)])

    def _fault_operand(self, fault_vec):
        """A fault vector as the step pipeline takes it: a tuple of one
        block-relative step per site of ``ledger.SCAN_FAULT_SITES`` (None:
        every site disarmed), or None on an ``inject=False`` engine."""
        if not self.inject:
            return None
        if fault_vec is None:
            return (DISARMED,) * len(SCAN_FAULT_SITES)
        fv = np.asarray(fault_vec)
        if fv.shape != (len(SCAN_FAULT_SITES),):
            raise ValueError(
                f"fault_vec must have shape ({len(SCAN_FAULT_SITES)},) "
                f"— one block-relative step per site in "
                f"{SCAN_FAULT_SITES} — got {fv.shape}")
        return tuple(int(v) for v in fv)

    def run_block(self, rs: RunState, take: int, fuse: bool = False,
                  fault_vec=None, force_overflow: bool = False):
        """Advance one ``take``-step block on a live :class:`RunState`
        (mutated in place); returns the block's metrics on the device.
        ``fuse=True`` also runs the between-block rebin (and, pruned, the
        prune) after the steps: the ``overlap_rebin`` path.  The
        ``block_dispatch`` span synchronizes the device before it stops.

        ``fault_vec`` arms the scan fault sites of an ``inject=True``
        engine for this block (``ledger.SCAN_FAULT_SITES`` layout,
        block-relative steps, -1 disarmed); ``force_overflow`` feeds the
        overflow monitor a synthetic trip (the forced inner-ladder
        overflow site: only the ``nstprune`` path has a monitor)."""
        if (fault_vec is not None or force_overflow) and not self.inject:
            raise ValueError("fault arming requires an inject=True engine")
        fv = self._fault_operand(fault_vec)
        with obs_span("block_dispatch", self.obs, steps=take,
                      fused_rebin=fuse) as sp:
            m = self._run_block(rs, take, fuse, fv, force_overflow)
            sp.sync(rs.force)
        self.obs.counter("md/blocks").inc()
        self.obs.counter("md/steps").inc(take)
        return m

    def _run_block(self, rs: RunState, take: int, fuse: bool, fv=None,
                   force_overflow: bool = False):
        if rs.sched is None:
            cell_f, force, m, ovf, rs.ledger = self.block_dense(
                rs.cell_f, rs.cell_i, rs.force, take, fv)
        else:
            sel, tiers, tiers_inner = rs.sched
            cell_f, force, m, ovf, rs.ledger = self.block_sched(
                rs.cell_f, rs.cell_i, rs.force, sel, take, tiers,
                tiers_inner, fv)
        rs.step += take
        if not fuse:
            rs.cell_f, rs.force = cell_f, force
            if ovf is not None:
                # read the overflow now, not at the next boundary, so a
                # final block's overflow is still counted and warned
                rs.disable = self._note_overflow(
                    1 if force_overflow else ovf)
            return m
        # overlap_rebin: the block's rebin / migration and, pruned, the
        # next block's prune follow its steps
        rs.cell_f, rs.cell_i, rs.force, diag = self._rebin(cell_f, rs.cell_i)
        if ovf is not None:
            sel2, cum, cum_inner, occ = self._prune(rs.cell_f, rs.cell_i)
            rs.sched = self._bucket_exec(
                sel2, cum, cum_inner, occ,
                disable_inner=self._note_overflow(ovf))
        rs.diags.append(self._host_diag(diag))
        return m

    def advance_schedule(self, rs: RunState):
        """The between-block rebin / migration and pair-schedule prune
        (the host-dispatched path; fused blocks already carried theirs)."""
        old_sched = rs.sched
        with obs_span("rebin_dispatch", self.obs) as sp:
            rs.cell_f, rs.cell_i, rs.force, diag = self._rebin(rs.cell_f,
                                                               rs.cell_i)
            rs.sched = self._refresh_schedule(
                rs.cell_f, rs.cell_i,
                disable_inner=old_sched is not None and rs.disable)
            sp.sync(rs.force)
        rs.disable = False
        rs.diags.append(self._host_diag(diag))

    def simulate(self, n_steps: int, state=None, collect: bool = True,
                 on_boundary=None):
        """Run ``n_steps`` in ``nstlist``-sized blocks.

        Returns ``((cell_f, cell_i), metrics, diags)``: the final block
        tensors, per-step numpy metrics (``pe``, ``ke``, ``mom``; with
        ``health`` also ``health/nonfinite`` per step and
        ``health/led_violation`` per pipeline invocation) and one
        diagnostics dict per rebin.  With ``overlap_rebin`` every block
        that another block follows carries its own rebin; the final block
        runs plain.

        ``on_boundary(rs)`` is called at every interior block boundary,
        before the boundary rebin: the host-visible point the MD server
        admits and retires replicas at.  It may replace ``rs.cell_f`` /
        ``rs.cell_i``; the rebin that follows derives the force carry and
        the pair schedule from whatever state it finds.  It cannot be
        combined with ``overlap_rebin`` (a fused block carries its own
        rebin).
        """
        nst = self.system.params.nstlist
        if on_boundary is not None and self.overlap_rebin:
            raise ValueError(
                "on_boundary is incompatible with overlap_rebin: the "
                "fused block carries its own rebin, so a boundary "
                "mutation would run under the already-derived schedule")
        rs = self.begin_run(state)
        blocks = []
        while rs.step < n_steps:
            take = min(nst, n_steps - rs.step)
            fuse = self.overlap_rebin and rs.step + take < n_steps
            m = self.run_block(rs, take, fuse=fuse)
            if collect:
                blocks.append(m)
            if not fuse and rs.step < n_steps:
                if on_boundary is not None:
                    on_boundary(rs)
                self.advance_schedule(rs)
        metrics = {}
        if blocks:
            metrics = {k: torch.cat([b[k] for b in blocks]).cpu().numpy()
                       for k in blocks[0]}
            obs_keys = [k for k in metrics if k.startswith("obs/")]
            if obs_keys:
                # the traced per-step ledger counters, as one record the
                # Perfetto exporter turns into predicted-lane counters
                self.obs.emit("step_counters",
                              data={k: metrics[k] for k in obs_keys})
        self.obs.snapshot(label="md/simulate", n_steps=n_steps,
                          backend=self.backend,
                          pipeline=self.pipeline_mode)
        return (rs.cell_f, rs.cell_i), metrics, rs.diags

    def gather_by_id(self, arrays, cell_i):
        """Host-side: reassemble per-atom arrays ordered by global id."""
        ids = np.asarray(torch.as_tensor(cell_i).cpu())[..., 0].reshape(-1)
        out = []
        for a in arrays:
            flat = np.asarray(torch.as_tensor(a).cpu()).reshape(
                ids.shape[0], -1)
            dest = np.zeros((self.system.n_atoms, flat.shape[-1]),
                            flat.dtype)
            valid = ids >= 0
            dest[ids[valid]] = flat[valid]
            out.append(dest)
        return out

    # ---- elasticity (rebuild / reshard) -----------------------------------

    def export_atoms(self, state) -> dict:
        """Mesh-independent snapshot of a cell state: per-atom positions
        and velocities in global-id order, numpy on the host (the portable
        half of a checkpoint, restorable onto any mesh or layout)."""
        cell_f, cell_i = state
        pos, vel = self.gather_by_id(
            [cell_f[..., :3], cell_f[..., 4:7]], cell_i)
        return {"pos": pos, "vel": vel}

    def rebuild(self, mesh: DomainMesh = None, system: MDSystem = None,
                **overrides) -> "MDEngine":
        """A fresh engine with this engine's construction parameters,
        selectively overridden.

        Any ``__init__`` keyword can be overridden; ``backend="..."``
        rewrites the halo spec's backend (the degrade ladder's signal ->
        serialized rung).  The new engine has its own step graphs; the
        caller re-enters through :meth:`begin_run` / :meth:`init_state`
        and releases this engine's graphs (:meth:`release_graphs`) when
        it drops it.
        """
        kw = dict(self._init_kwargs)
        backend = overrides.pop("backend", None)
        kw.update(overrides)
        if backend is not None:
            base = kw["spec"] if kw["spec"] is not None else \
                HaloSpec(axis_names=AXES, widths=(1, 1, 1))
            kw["spec"] = dataclasses.replace(base, backend=backend)
        return MDEngine(system if system is not None else self.system,
                        mesh if mesh is not None else self.mesh, **kw)

    def reshard(self, mesh: DomainMesh, state=None, atoms=None,
                **overrides) -> "MDEngine":
        """Elastic reshard: rebuild this engine on another (virtual) mesh
        and carry the atoms over, the device-loss shrink path.

        Pass either the live cell ``state`` (exported here) or an exported
        ``atoms`` dict (the checkpointed form a lost device's state is
        recovered from).  Returns the new engine; :meth:`init_state` bins
        the carried atoms under its layout.
        """
        if atoms is None:
            if state is None:
                raise ValueError("reshard needs `state` or `atoms`")
            atoms = self.export_atoms(state)
        dt = self.system.pos.dtype
        system = dataclasses.replace(
            self.system,
            pos=np.asarray(atoms["pos"], dt),
            vel=np.asarray(atoms["vel"], dt))
        return self.rebuild(mesh=mesh, system=system, **overrides)

    def release_graphs(self):
        """Drop this engine's captured step graphs and their memory (an
        engine another replaces); raises while a capture is open."""
        if self.block_graphs is not None:
            self.block_graphs.clear()

    def __repr__(self):
        return (f"MDEngine(n_atoms={self.system.n_atoms}, "
                f"mesh={self.axis_sizes}, backend={self.backend!r}, "
                f"device={str(self.device)!r})")
