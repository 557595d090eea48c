"""MD time-stepping on one card over a virtual domain mesh.

The port of the JAX package's ``core/md/engine.py`` with the dense force
backend and the serialized step pipeline.  The step mirrors the paper's
Algorithm 2 (GPU-resident skeleton):

  1. kick-drift                         (velocity Verlet, first half)
  2. coordinate halo exchange           (``plan.fwd_local``)
  3. non-bonded forces, local + halo    (``forces.compute_forces``)
  4. force halo exchange + accumulate   (``plan.rev_local``)
  5. final kick

An ``nstlist`` block of steps runs on the device with no host read; the
rebin / migration runs between blocks.  Every domain of the mesh lives on
the engine's device as a leading tensor dim:

  cell_f (Dz, Dy, Dx, cz, cy, cx, K, 7)  [x, y, z, charge, vx, vy, vz]
  cell_i (Dz, Dy, Dx, cz, cy, cx, K, 2)  [atom id (-1 = empty), type]
  force  (Dz, Dy, Dx, cz, cy, cx, K, 3)  forces at t (the Verlet carry)

The reference's other knobs (pruned force backends, the double-buffered
pipeline, fused rebin, wire compression, tracing, fault injection,
health monitors, the rolling prune) come with later slices of the port;
asking for any of them raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.convert import cells_to_domains
from repro_torch.core.halo_plan import HaloPlan, HaloSpec
from repro_torch.core.md import integrate
from repro_torch.core.md.cells import choose_layout
from repro_torch.core.md.domain import AXES, rebin
from repro_torch.core.md.forces import compute_forces, stencil_pairs
from repro_torch.core.md.system import MDSystem
from repro_torch.core.pipeline.step_pipeline import (
    PIPELINE_MODES,
    StepFns,
    StepPipeline,
)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import DomainMesh

_TORCH_DTYPE = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}

# the reference's force backends; only "dense" is in this slice
_FORCE_BACKENDS = ("dense", "sparse", "pallas")


@dataclasses.dataclass
class RunState:
    """Live block-loop state of one simulation run.

    :meth:`MDEngine.begin_run` creates it; :meth:`MDEngine.run_block` and
    :meth:`MDEngine.advance_schedule` mutate it in place.
    """

    cell_f: torch.Tensor
    cell_i: torch.Tensor
    force: torch.Tensor       # velocity-Verlet force carry (post-rebin)
    step: int                 # steps completed so far
    diags: list               # per-rebin migration diagnostics (ints)


def _not_ported(knob: str, value, slice_name: str):
    raise NotImplementedError(
        f"MDEngine({knob}={value!r}) is not ported yet: it comes with "
        f"{slice_name}")


class MDEngine:
    """Binds a system + virtual mesh + HaloSpec into the step programs.

    ``spec`` selects the halo backend and widths; the engine fills in the
    periodic wrap shifts from the box and builds one :class:`HaloPlan`
    used by every step, rebin and force pass.  ``device`` defaults to
    ``"cuda"`` and raises when CUDA is absent.
    """

    def __init__(self, system: MDSystem, mesh: DomainMesh,
                 spec: HaloSpec | None = None,
                 r_list_factor: float = 1.08, mig_frac: float = 0.125,
                 pipeline: str = "off",
                 overlap_rebin: bool = False,
                 force_backend: str = "dense",
                 capacity_safety: float = 2.2,
                 nstprune: int = 0,
                 wire_dtype: str | None = None,
                 obs=None, trace: bool = False,
                 inject: bool = False, health: bool = False,
                 device="cuda"):
        self.device = resolve_device(device)
        if spec is None:
            spec = HaloSpec(axis_names=AXES, widths=(1, 1, 1))
        if spec.axis_names != tuple(AXES):
            raise ValueError(f"MD halo spec must decompose over {AXES}, "
                             f"got {spec.axis_names}")
        if pipeline not in PIPELINE_MODES:
            raise ValueError(f"unknown pipeline mode {pipeline!r}; "
                             f"available: {PIPELINE_MODES}")
        if min(spec.widths) < 1:
            raise ValueError("MD halo widths must be >= 1 (the NB stencil "
                             "consumes one halo cell layer)")
        if force_backend not in _FORCE_BACKENDS:
            raise ValueError(f"unknown force backend {force_backend!r}; "
                             f"available: {_FORCE_BACKENDS}")
        later = "a later slice of the port"
        if pipeline != "off":
            _not_ported("pipeline", pipeline, "the step-pipeline slice")
        if overlap_rebin:
            _not_ported("overlap_rebin", overlap_rebin,
                        "the step-pipeline slice")
        if force_backend != "dense":
            _not_ported("force_backend", force_backend,
                        "the pruned pair-schedule slice")
        if int(nstprune):
            _not_ported("nstprune", nstprune,
                        "the pruned pair-schedule slice")
        if wire_dtype is not None or spec.wire_dtype is not None:
            _not_ported("wire_dtype", wire_dtype or spec.wire_dtype,
                        "the wire-compression slice")
        for knob, value in (("obs", obs), ("trace", trace),
                            ("inject", inject), ("health", health)):
            if value:
                _not_ported(knob, value, later)
        if system.pos.dtype not in _TORCH_DTYPE:
            raise TypeError(f"system dtype {system.pos.dtype} not "
                            "supported: float32 or float64")
        self.system = system
        self.mesh = mesh
        self.pipeline_mode = pipeline
        self.force_backend = force_backend
        self.dtype = _TORCH_DTYPE[system.pos.dtype]
        mesh_shape = tuple(mesh.shape[a] for a in AXES)
        self.axis_sizes = mesh_shape
        r_list = system.params.ff.r_cut * r_list_factor
        self.layout = choose_layout(system.box, mesh_shape, r_list,
                                    system.n_atoms, safety=capacity_safety)
        self.mig_cap = max(64, int(self.layout.pool * mig_frac))
        n_dense = len(stencil_pairs()) * self.layout.n_local_cells
        self._pair_stats = {
            "n_pairs_dense": n_dense,
            "k_capacity": self.layout.capacity,
            "dense_slot_pairs": n_dense * self.layout.capacity ** 2,
            "evaluated_slot_pairs": n_dense * self.layout.capacity ** 2,
            "prune_ratio": 1.0,
            "force_backend": force_backend,
        }
        if spec.wrap_shift is None:
            ws = np.zeros((3, 4), system.pos.dtype)
            for d in range(3):
                ws[d, d] = system.box[d]
            spec = spec.with_wrap_shift(ws)
        # byte accounting: each exchanged cell carries `capacity` slots of
        # 4 floats (x, y, z, charge); the (K, 2) int32 cell_i exchange is
        # reported separately (halo_stats' bytes_index)
        self.plan = HaloPlan.build(
            dataclasses.replace(spec, dtype=np.dtype(system.pos.dtype).name,
                                feature_elems=4 * self.layout.capacity),
            mesh, device=self.device)
        self.pipeline = StepPipeline.build(self.plan, self._make_step_fns(),
                                           mode=self.pipeline_mode)

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
        return self.plan.stats(self.layout.cells_per_domain,
                               index_elems=2 * K, index_itemsize=4,
                               occupancy=occupancy,
                               pipeline=self.pipeline_mode)

    def pair_stats(self) -> dict:
        """Evaluated-slot-pair accounting per domain per step (dense)."""
        return dict(self._pair_stats)

    def overlap_stats(self) -> dict:
        """Per-step overlap model at this engine's pipeline mode."""
        return self.plan.stats(self.layout.cells_per_domain,
                               pipeline=self.pipeline_mode)["overlap"]

    # ---- the force pass --------------------------------------------------

    def _trim_ext(self, ext):
        """First halo cell layer of extended blocks (the NB stencil reaches
        exactly one cell); identity at the default widths."""
        if max(self.spec.widths) == 1:
            return ext
        n = self.layout.cells_per_domain
        return ext[(slice(None),) * 3
                   + tuple(slice(0, n[d] + 1) for d in range(3))]

    def _pad_force(self, F_trim, ext_shape):
        """Zero-pad trimmed forces back to the full extended blocks."""
        if max(self.spec.widths) == 1:
            return F_trim
        n = self.layout.cells_per_domain
        F = torch.zeros(tuple(ext_shape[:6]) + F_trim.shape[6:],
                        dtype=F_trim.dtype, device=F_trim.device)
        F[(slice(None),) * 3
          + tuple(slice(0, n[d] + 1) for d in range(3))] = F_trim
        return F

    def force_fn(self, cell_f, cell_i):
        """One force pass on block tensors: coordinate halo -> forces ->
        force halo (paper Alg. 3/6); returns (forces, total PE)."""
        ext_f = self.plan.fwd_local(cell_f[..., :4])
        ext_i = self.plan.fwd_local(cell_i, wrap_shift=None)
        F_trim, pe = compute_forces(self._trim_ext(ext_f),
                                    self._trim_ext(ext_i), self.layout,
                                    self.system.params.ff)
        f_local = self.plan.rev_local(self._pad_force(F_trim, ext_f.shape))
        return f_local, torch.sum(pe)

    # ---- step physics, split at the halo seams (StepFns) ---------------

    def _make_step_fns(self) -> StepFns:
        params = self.system.params
        mass = params.mass
        layout, ff = self.layout, params.ff
        dtype, dev = self.dtype, self.device
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

        def force(ext_f, ctx):
            F_trim, pe = compute_forces(self._trim_ext(ext_f),
                                        ctx["ext_i_trim"], layout, ff)
            return self._pad_force(F_trim, ext_f.shape), {"pe": torch.sum(pe)}

        def finish(cell_f, vel_half, f_new, ctx):
            valid = ctx["cell_i"][..., 0] >= 0
            vmask = valid[..., None]
            f_new = torch.where(vmask, f_new, zero)
            # kick; the where between the product and the sum keeps the
            # rounding the same as the reference's
            vel_new = vel_half + torch.where(vmask, f_new * half_dt_m, zero)
            cell_f = cell_f.clone()
            cell_f[..., 4:7] = torch.where(vmask, vel_new, zero)
            ke = integrate.kinetic_energy(vel_new, valid, mass)
            mom = integrate.momentum(torch.where(vmask, vel_new, zero),
                                     valid, mass)
            return cell_f, f_new, {"ke": ke, "mom": mom}

        return StepFns(begin=begin, force=force, finish=finish)

    def _block_ctx(self, cell_i):
        return {"cell_i": cell_i,
                "ext_i_trim": self._trim_ext(
                    self.plan.fwd_local(cell_i, wrap_shift=None))}

    def rebin_fn(self, cell_f, cell_i):
        """Wrap, migrate, re-bin, then the force carry for the new bins."""
        new_f, new_i, diag = rebin(cell_f, cell_i, self.layout, self.mig_cap)
        force, _pe = self.force_fn(new_f[..., :4], new_i)
        force = torch.where(new_i[..., 0:1] >= 0, force,
                            torch.zeros((), dtype=force.dtype,
                                        device=force.device))
        return new_f, new_i, force, diag

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

    def begin_run(self, state=None) -> RunState:
        """Open a block-loop run: bin (or adopt) the state, run the first
        rebin, and return the live :class:`RunState`."""
        cell_f, cell_i = self.init_state() if state is None else state
        cell_f, cell_i, force, diag = self.rebin_fn(cell_f, cell_i)
        return RunState(cell_f, cell_i, force, 0, [self._host_diag(diag)])

    def run_block(self, rs: RunState, take: int):
        """Advance one ``take``-step block on a live :class:`RunState`
        (mutated in place); returns the block's metrics on the device.
        No rebin runs inside a block."""
        rs.cell_f, rs.force, m = self.pipeline.run_local(
            rs.cell_f, rs.force, take, self._block_ctx(rs.cell_i))
        rs.step += take
        return m

    def advance_schedule(self, rs: RunState):
        """The between-block rebin / migration."""
        rs.cell_f, rs.cell_i, rs.force, diag = self.rebin_fn(rs.cell_f,
                                                             rs.cell_i)
        rs.diags.append(self._host_diag(diag))

    def simulate(self, n_steps: int, state=None, collect: bool = True):
        """Run ``n_steps`` in ``nstlist``-sized blocks.

        Returns ``((cell_f, cell_i), metrics, diags)``: the final block
        tensors, per-step numpy metrics (``pe``, ``ke``, ``mom``) and one
        diagnostics dict per rebin.
        """
        nst = self.system.params.nstlist
        rs = self.begin_run(state)
        blocks = []
        while rs.step < n_steps:
            take = min(nst, n_steps - rs.step)
            m = self.run_block(rs, take)
            if collect:
                blocks.append(m)
            if rs.step < n_steps:
                self.advance_schedule(rs)
        metrics = {}
        if blocks:
            metrics = {k: torch.cat([b[k] for b in blocks]).cpu().numpy()
                       for k in blocks[0]}
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

    def __repr__(self):
        return (f"MDEngine(n_atoms={self.system.n_atoms}, "
                f"mesh={self.axis_sizes}, backend={self.backend!r}, "
                f"device={str(self.device)!r})")
