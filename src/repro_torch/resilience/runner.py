"""ResilientMDRunner: the self-healing MD block loop.

The port of the JAX package's ``resilience/runner.py``.  It drives
``MDEngine.begin_run / run_block / advance_schedule`` as
``MDEngine.simulate`` does, visiting bitwise the same states when nothing
fires, but between blocks it also:

* arms the :class:`~repro_torch.resilience.faults.FaultPlan`'s scan and
  host faults for the coming block,
* reads the block's metrics to the host once (one copy of every device
  metric) and scans the health scalars through
  :class:`~repro_torch.resilience.monitors.HealthMonitor`,
* checkpoints every clean block boundary in the reference's global layout
  (``cell_f`` ``(Gz, Gy, Gx, K, 7)``, ``cell_i`` ``(..., K, 2)``, plus
  ``atoms``, through ``convert.domains_to_cells``), the state before the
  boundary rebin, so restore + ``begin_run`` replays the rebin the
  uninterrupted run performs: a rollback is bitwise,
* on a tripped monitor asks the
  :class:`~repro_torch.resilience.policy.RecoveryPolicy`: rollback with
  bounded backoff, degrade down the ladder (``MDEngine.rebuild`` with the
  rung's overrides), reshard onto a spare mesh (device loss; on one card
  a smaller virtual :class:`~repro_torch.launch.mesh.DomainMesh`), or
  raise ``RecoveryExhausted``.

An engine the runner replaces has its step graphs released at once
(``MDEngine.release_graphs``), between blocks, never during a capture.
A :class:`~repro_torch.resilience.policy.Watchdog` observes each block's
wall time.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.convert import cells_to_domains, domains_to_cells
from repro_torch.core.md.engine import MDEngine
from repro_torch.launch.mesh import DomainMesh
from repro_torch.resilience.faults import (
    DeviceLost,
    FaultPlan,
    ProcessKilled,
    RecoveryExhausted,
    ResilienceError,
)
from repro_torch.resilience.monitors import HealthEvent, HealthMonitor
from repro_torch.resilience.policy import RecoveryPolicy, Watchdog


def host_metrics(m: dict) -> dict:
    """A block's metrics as numpy: every device metric in one copy to the
    host (flattened into one float64 tensor, exact for the f32 / f64 /
    int32 metrics), the host-side ones (ledger flag, ``obs/*``) as they
    are."""
    dev = {k: v for k, v in m.items() if v.device.type != "cpu"}
    out = {k: v.numpy() for k, v in m.items() if k not in dev}
    if dev:
        flat = torch.cat([v.reshape(-1).to(torch.float64)
                          for v in dev.values()]).cpu().numpy()
        at = 0
        for k, v in dev.items():
            n = v.numel()
            out[k] = flat[at:at + n].reshape(tuple(v.shape)).astype(
                torch.empty((), dtype=v.dtype).numpy().dtype)
            at += n
    return {k: out[k] for k in m}


class ResilientMDRunner:
    """Fault-injecting, self-healing driver around one :class:`MDEngine`.

    The engine must be built with ``health=True`` (the in-step monitors
    are the detection path) and, if the plan carries scan or overflow
    faults, with ``inject=True``.  ``spare_mesh`` is the failover mesh the
    device-loss -> ``reshard`` escalation consumes.
    """

    def __init__(self, engine: MDEngine, ckpt_dir,
                 plan: Optional[FaultPlan] = None,
                 policy: Optional[RecoveryPolicy] = None,
                 monitor: Optional[HealthMonitor] = None,
                 watchdog: Optional[Watchdog] = None,
                 spare_mesh: Optional[DomainMesh] = None,
                 keep: int = 3):
        if not engine.health:
            raise ValueError("ResilientMDRunner needs an MDEngine built "
                             "with health=True (the detection path)")
        self.plan = plan if plan is not None else FaultPlan()
        if self.plan.scan_or_overflow_sites and not engine.inject:
            raise ValueError("the fault plan carries scan/overflow sites; "
                             "build the engine with inject=True")
        self.engine = engine
        self.policy = policy if policy is not None else RecoveryPolicy()
        self.monitor = monitor if monitor is not None else \
            HealthMonitor(registry=engine.obs)
        self.watchdog = watchdog if watchdog is not None else Watchdog()
        self.spare_mesh = spare_mesh
        self._mgr = CheckpointManager(ckpt_dir, keep=keep)
        self.report: dict = {"events": [], "recoveries": [],
                             "wasted_steps": 0, "checkpoint_steps": [],
                             "resumed_from": None, "resharded": False}

    # -- checkpoint plumbing ----------------------------------------------

    @staticmethod
    def _like(eng: MDEngine):
        """The checkpoint's structure, shapes and dtypes (meta tensors)."""
        G, K = eng.layout.global_cells, eng.layout.capacity
        dt, n = eng.dtype, eng.system.n_atoms

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")
        return {
            "cell_f": meta(tuple(G) + (K, 7), dt),
            "cell_i": meta(tuple(G) + (K, 2), torch.int32),
            "atoms": {"pos": meta((n, 3), dt), "vel": meta((n, 3), dt)},
        }

    def _save(self, eng: MDEngine, state, step: int, disable: bool):
        cell_f, cell_i = domains_to_cells(*state)
        self._mgr.save(step,
                       {"cell_f": cell_f, "cell_i": cell_i,
                        "atoms": eng.export_atoms(state)},
                       extra={"step": int(step), "disable": bool(disable)})
        self.report["checkpoint_steps"].append(int(step))
        eng.obs.counter("resilience/checkpoints").inc()

    def _load(self, eng: MDEngine):
        """The newest valid checkpoint: ``(step, tree, extra)`` with the
        cells as ``eng``'s domain blocks on its device, or None."""
        res = self._mgr.restore_latest(self._like(eng), device=eng.device)
        if res is None:
            return None
        step_c, tree = res
        tree["cell_f"], tree["cell_i"] = (
            x.contiguous() for x in cells_to_domains(
                tree["cell_f"], tree["cell_i"], eng.axis_sizes))
        return step_c, tree, self._mgr.manifest(step_c)["extra"]

    def _begin(self, eng: MDEngine, step_c, tree, extra):
        rs = eng.begin_run((tree["cell_f"], tree["cell_i"]),
                           disable_inner=bool(extra.get("disable", False)))
        rs.step = int(extra.get("step", step_c))
        return rs

    def _restore(self, eng: MDEngine):
        """Rewind to the last good block: the restored pre-rebin state,
        and ``begin_run`` replays the boundary rebin / prune exactly."""
        res = self._load(eng)
        if res is None:
            raise ResilienceError("no valid checkpoint to roll back to")
        rs = self._begin(eng, *res)
        self.monitor.reset()
        return rs

    def _replace_engine(self, new: MDEngine):
        """Adopt ``new`` and release the dropped engine's step graphs."""
        old, self.engine = self.engine, new
        old.release_graphs()

    # -- recovery actions --------------------------------------------------

    def _record(self, action: str, kinds, step0: int, take: int,
                events, attempt: int, detail: str = ""):
        latency = [int(step0 + take - ev.step) for ev in events] or [0]
        rec = {"action": action, "kinds": sorted(kinds),
               "block_step": int(step0), "attempt": int(attempt),
               "detection_latency_steps": max(latency),
               "rollback_steps": int(take), "detail": detail}
        self.report["recoveries"].append(rec)
        self.engine.obs.emit("recovery", **rec)

    def _degrade(self, rung):
        """Rebuild the engine one rung down and retire the sites the rung
        physically removes."""
        self._replace_engine(self.engine.rebuild(**rung.overrides))
        self.policy.ladder.apply(rung)
        self.plan.disable_sites(rung.clears)
        self.engine.obs.emit("degrade", rung=rung.name,
                             overrides=rung.overrides,
                             clears=list(rung.clears))
        return self._restore(self.engine)

    def _reshard(self, step0: int):
        """Device loss: recover the portable atom snapshot from the last
        checkpoint, rebuild on the spare mesh, re-anchor the checkpoint
        chain under the new layout."""
        if self.spare_mesh is None:
            raise DeviceLost(f"device loss at step {step0} with no spare "
                             "mesh to reshard onto")
        res = self._load(self.engine)
        if res is None:
            raise DeviceLost("device loss before any checkpoint existed")
        step_c, tree, extra = res
        atoms = {k: v.cpu().numpy() for k, v in tree["atoms"].items()}
        eng2 = self.engine.reshard(self.spare_mesh, atoms=atoms)
        self._replace_engine(eng2)
        self.spare_mesh = None
        self.report["resharded"] = True
        eng2.obs.emit("reshard", step=step_c, mesh_shape=eng2.axis_sizes)
        state2 = eng2.init_state()
        disable = bool(extra.get("disable", False))
        self._save(eng2, state2, step_c, disable)
        rs = eng2.begin_run(state2, disable_inner=disable)
        rs.step = int(extra.get("step", step_c))
        self.monitor.reset()
        return rs

    # -- the loop ----------------------------------------------------------

    def run(self, n_steps: int, state=None, collect: bool = True,
            resume: bool = True):
        """Run ``n_steps``; returns ``((cell_f, cell_i), metrics,
        report)``.  With ``resume=True`` a valid checkpoint in
        ``ckpt_dir`` continues that run (the post-kill path)."""
        eng = self.engine
        nst = eng.system.params.nstlist
        rs = None
        if resume:
            res = self._load(eng)
            if res is not None:
                rs = self._begin(eng, *res)
                self.report["resumed_from"] = rs.step
        if rs is None:
            if state is None:
                state = eng.init_state()
            # step-0 anchor: the PRE-rebin state, so a rollback to it
            # replays begin_run's rebin exactly once, like the clean run
            self._save(eng, state, 0, False)
            rs = eng.begin_run(state)

        all_metrics, attempt = [], 0
        while rs.step < n_steps:
            eng = self.engine
            take = min(nst, n_steps - rs.step)
            step0 = rs.step

            # host-side faults fire at the boundary, before the block
            host = self.plan.host_pending(step0, step0 + take)
            kills = [i for i, s in host if s.site == "proc_kill"]
            if kills:
                self.plan.mark_fired(kills)
                self._mgr.wait()
                raise ProcessKilled(
                    f"injected process kill at step {step0}")
            losses = [i for i, s in host if s.site == "device_loss"]
            if losses:
                self.plan.mark_fired(losses)
                ev = HealthEvent("device_loss", step0)
                self.report["events"].append(vars(ev))
                act = self.policy.decide({"device_loss"}, attempt)
                self._record(act.kind, {"device_loss"}, step0, 0, [ev],
                             attempt)
                rs = self._reshard(step0)
                attempt = 0
                continue

            fv, armed = self.plan.arm_scan(step0, step0 + take)
            ovf, ovf_armed = self.plan.overflow_armed(step0, step0 + take)
            t0 = time.time()
            m = eng.run_block(rs, take, fault_vec=fv, force_overflow=ovf)
            mh = host_metrics(m)       # the boundary's one host read
            self.watchdog.observe(step0 // max(nst, 1),
                                  time.time() - t0)
            self.plan.mark_fired(armed)
            self.plan.mark_fired(ovf_armed)
            if ovf:
                # the engine's own outer-ladder fallback IS the recovery
                # (next block runs the outer list); record, don't rewind
                ev = HealthEvent("overflow", step0)
                self.report["events"].append(vars(ev))
                self._record("engine_fallback", {"overflow"}, step0, 0,
                             [ev], attempt, detail="outer_ladder")

            events = self.monitor.check_block(mh, step0)
            if events:
                self.report["events"].extend(vars(e) for e in events)
                kinds = {e.kind for e in events}
                act = self.policy.decide(kinds, attempt)
                self.report["wasted_steps"] += take
                self._record(act.kind, kinds, step0, take, events,
                             attempt,
                             detail=act.rung.name if act.rung else "")
                if act.kind == "rollback":
                    time.sleep(act.backoff_s)
                    rs = self._restore(eng)
                    attempt += 1
                elif act.kind == "degrade":
                    rs = self._degrade(act.rung)
                    attempt = 0
                elif act.kind == "reshard":
                    rs = self._reshard(step0)
                    attempt = 0
                else:
                    raise RecoveryExhausted(
                        f"unrecoverable events {sorted(kinds)} at step "
                        f"{step0}: retries and degrade ladder exhausted")
                continue

            # clean block: commit it
            attempt = 0
            if collect:
                all_metrics.append(mh)
            self._save(eng, (rs.cell_f, rs.cell_i), rs.step,
                       bool(rs.sched is not None and rs.disable))
            if rs.step < n_steps:
                eng.advance_schedule(rs)

        self._mgr.wait()
        metrics = {}
        if collect and all_metrics:
            keys = set(all_metrics[0])
            for mh in all_metrics[1:]:
                keys &= set(mh)
            metrics = {k: np.concatenate([np.atleast_1d(m[k])
                                          for m in all_metrics])
                       for k in sorted(keys)}
        self.report["watchdog_events"] = self.watchdog.events
        self.report["fault_plan"] = self.plan.summary()
        self.report["ladder"] = self.policy.ladder.summary()
        self.engine.obs.emit("resilient_run", n_steps=n_steps,
                             recoveries=len(self.report["recoveries"]),
                             wasted_steps=self.report["wasted_steps"],
                             resharded=self.report["resharded"])
        return (rs.cell_f, rs.cell_i), metrics, self.report
