"""Training driver on one card: auto-resume, straggler watchdog, logging.

Port of ``src/repro/runtime/train_loop.py``, with its fault-tolerance
contract:
  * the loop can be killed at ANY step and restarted with the same config;
    it resumes from the latest valid checkpoint bit-exactly (deterministic
    data + a deterministic step: on the card too, every sum of the step
    runs in a fixed order),
  * checkpoint writes are atomic (``ckpt/checkpoint.py``), so mid-save
    crashes roll back to the previous step,
  * a per-step watchdog tracks an EWMA of step time; a step exceeding
    ``threshold x EWMA`` fires the straggler hook.

``ckpt_every <= 0`` writes no checkpoint at all (the port's; the
reference divides by it): a full-width qwen3-1.7b checkpoint, float32
parameters and both moments, is 24.4 GB.  A checkpoint holds the
reference's state tree, ``{"params": <stacked
parameter tree>, "opt": {"step", "m", "v"}}`` (``convert``), with
``extra = {"next_step", "data_state"}``: each package resumes the
other's runs.  The step clock stops after ``torch.cuda.synchronize()``
on the card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.convert import (adamw_state_from_jax, adamw_state_to_jax,
                                 lm_params_from_jax, lm_params_to_jax)
from repro_torch.data.synthetic import DataConfig, SyntheticStream
from repro_torch.optim import adamw
from repro_torch.resilience.policy import Watchdog

__all__ = ["Watchdog", "TrainLoopConfig", "run_training"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    async_save: bool = False


def run_training(loop_cfg: TrainLoopConfig, program, data_cfg: DataConfig,
                 init_params_fn, batch_to_inputs=None,
                 fail_at_step: Optional[int] = None,
                 watchdog: Optional[Watchdog] = None,
                 log: Optional[Callable[[str], None]] = print):
    """Run (or resume) training; returns (params, opt_state, history).

    ``program`` is a ``TrainProgram`` (``launch/steps.py``).
    ``init_params_fn()`` fills a fresh run's parameters: it returns a
    state dict for the program's model (e.g. ``convert.lm_params_from_jax``
    of the reference's params), or initialises the model itself (e.g.
    ``lambda: program.model.init(gen)``).  ``fail_at_step`` raises just
    after that step completes (BEFORE its checkpoint).  History entries:
    ``step``, ``loss``, ``grad_norm``, ``dt`` (seconds).
    """
    mgr = CheckpointManager(loop_cfg.ckpt_dir, keep=loop_cfg.keep,
                            async_save=loop_cfg.async_save)
    watchdog = watchdog or Watchdog()
    model = program.model
    dev = model.device
    per_unit = len(model.cfg.pattern_unit)

    start_step = 0
    resume = mgr.latest_valid_step()
    if resume is not None:
        restored = mgr.restore(resume, {"params": program.abstract_params,
                                        "opt": program.abstract_opt})
        model.load_state_dict(lm_params_from_jax(restored["params"]))
        opt_state = adamw_state_from_jax(restored["opt"], dev)
        del restored
        extra = mgr.manifest(resume)["extra"]
        start_step = int(extra.get("next_step", resume))
        if log:
            log(f"[resume] step {start_step} from checkpoint {resume}")
    else:
        init = init_params_fn()
        if isinstance(init, dict):
            model.load_state_dict(init)
        opt_state = adamw.init_state(program.params)
    params = program.params

    stream = SyntheticStream(data_cfg, start_step=start_step)
    history = []
    try:
        for step in range(start_step, loop_cfg.total_steps):
            batch_np = stream.next()
            batch = {"tokens": torch.from_numpy(batch_np).to(dev)}
            if batch_to_inputs is not None:
                batch = batch_to_inputs(batch_np)
            t0 = time.time()
            params, opt_state, metrics = program.step_fn(params, opt_state,
                                                         batch)
            loss = float(metrics["loss" if "loss" in metrics else "ce"])
            # the loss read above waits for the loss only; the update is
            # still in flight: wait for it so dt clocks the step
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.time() - t0
            watchdog.observe(step, dt)
            history.append({"step": step, "loss": loss,
                            "grad_norm": float(metrics["grad_norm"]),
                            "dt": dt})
            if log and step % loop_cfg.log_every == 0:
                log(f"[step {step}] loss={loss:.4f} {dt * 1e3:.0f}ms")
            done = step + 1
            if loop_cfg.ckpt_every > 0 and (
                    done % loop_cfg.ckpt_every == 0 or
                    done == loop_cfg.total_steps):
                mgr.save(done, {"params": lm_params_to_jax(params, per_unit),
                                "opt": adamw_state_to_jax(opt_state,
                                                          per_unit)},
                         extra={"next_step": done,
                                "data_state": stream.state()})
            if fail_at_step is not None and done == fail_at_step:
                raise RuntimeError(f"injected failure after step {step}")
    finally:
        mgr.wait()
        stream.close()
    return params, opt_state, history
