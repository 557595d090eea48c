"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --steps 6 --batch 4 --seq 1024 --ckpt-every 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --reduced --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \
      --reduced --steps 20 --device cpu --moe-dispatch dense
  PYTHONPATH=src python -m repro_torch.launch.train --arch jamba-v0.1-52b \
      --n-layers 8 --expert-share 0/8 --steps 6 --batch 4 --seq 1024 \
      --ckpt-every 0

Port of ``src/repro/launch/train.py`` with its flags: the train step of
``launch/steps.py`` (grad accumulation, remat, AdamW with
``lr``, ``warmup_steps=10``, ``total_steps=--steps``) under
``run_training`` (checkpoint / resume, straggler watchdog) on one card,
parameters drawn from ``torch.Generator`` seed 0.  ``--device`` (default
``cuda``; ``cpu`` runs the plain forms), ``--fail-at-step`` (raise after
that step, before its checkpoint; a rerun resumes), ``--ckpt-every 0``
(no checkpoints) and ``--n-layers`` (the config at that depth, its widths
unchanged: olmoe-1b-7b's f32 training state fits one 80 GB card at 4 of
its 16 layers) and ``--expert-share I/N`` (every MoE layer holds share I
of N of its experts, one card's part of N-way expert parallelism with no
exchange: ``models.moe``; checkpoints are refused, since the other
experts live on other cards) are the port's.
Checkpoints go to ``--ckpt-dir`` (default ``build/repro_train`` under
the repository root).
"""
from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.data.synthetic import DataConfig
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import adamw
from repro_torch.runtime.serve_loop import refuse_encdec
from repro_torch.runtime.train_loop import (TrainLoopConfig, Watchdog,
                                            run_training)

DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_train"


def expert_share(text: str):
    """``"I/N"`` as ``(I, N)``."""
    try:
        index, count = (int(x) for x in text.split("/"))
    except ValueError:
        raise argparse.ArgumentTypeError(f"expert share {text!r}: I/N")
    return index, count


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--moe-dispatch", default="fused")
    ap.add_argument("--data-vocab", type=int, default=None)
    ap.add_argument("--copy-period", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--expert-share", type=expert_share, default=None,
                    metavar="I/N")
    return ap.parse_args(argv)



def main(argv=None):
    """Train (or resume); returns ``(program, params, opt_state,
    history)``."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduce()
    refuse_encdec(cfg, "launch.train")
    if args.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=args.seq,
                                global_batch=args.batch)
    prog = make_train_step(
        cfg, shape,
        ocfg=adamw.AdamWConfig(lr=args.lr, warmup_steps=10,
                               total_steps=args.steps),
        microbatches=args.microbatches, device=dev,
        moe_dispatch=args.moe_dispatch, expert_share=args.expert_share)
    print(f"arch={cfg.name} on {dev} microbatches={prog.microbatches}"
          + ("" if args.expert_share is None else
             " expert share {}/{}".format(*args.expert_share)))

    data_cfg = DataConfig(vocab=args.data_vocab or cfg.vocab,
                          seq_len=args.seq, global_batch=args.batch,
                          seed=0, copy_period=args.copy_period)
    loop = TrainLoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every)
    model = prog.model
    wd = Watchdog(on_straggler=lambda s, dt, ew: print(
        f"[watchdog] step {s} took {dt:.2f}s (ewma {ew:.2f}s)"))
    params, opt, hist = run_training(
        loop, prog, data_cfg,
        lambda: model.init(torch.Generator(device=dev).manual_seed(0)),
        fail_at_step=args.fail_at_step, watchdog=wd)
    print(f"done: final loss {hist[-1]['loss']:.4f} over "
          f"{len(hist)} steps this run")
    return prog, params, opt, hist


if __name__ == "__main__":
    main()
