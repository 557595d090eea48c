"""Serving launcher: batched LM waves, or continuous MD batching, on one
card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --reduced --requests 16 --batch 4 --new-tokens 16 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
      --reduced --device cpu [--moe-dispatch dense]

  PYTHONPATH=src python -m repro_torch.launch.serve --md \
      --replicas 8 --atoms 200 --steps 40 --backend dense [--device cpu]

Runs on the card unless ``--device cpu`` is given (and raises without
CUDA).  ``--moe-dispatch`` (the port's; default ``fused``, as the
reference's ``LM``) picks an MoE model's dispatch.  LM weights are
random, drawn from a ``torch.Generator`` seeded with 0; prompts from
``numpy.random.RandomState(0)``.  ``--md`` serves
``--replicas`` grappa-like replicas (seeds 0, 1, ...) through
:class:`~repro_torch.serve.SimServer` on a (1, 1, 1) mesh with the
default bucket ladder and prints the reference's summary line.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.runtime.serve_loop import BatchServer, Request, \
    refuse_encdec, throughput_stats


def main_md(args):
    """Continuous batching of MD replicas (the SimServer subsystem)."""
    from repro_torch.core.md.domain import AXES
    from repro_torch.core.md.system import make_grappa_like
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import BucketLadder, SimServer

    ladder = BucketLadder()
    server = SimServer(make_mesh((1, 1, 1), AXES), ladder,
                       block_steps=args.nstlist,
                       engine_kwargs={"force_backend": args.backend},
                       device=args.device)
    bucket = ladder.atom_bucket_for(args.atoms)
    handles = [server.submit(
        make_grappa_like(args.atoms, seed=i, nstlist=args.nstlist,
                         box_atoms=bucket), args.steps)
        for i in range(args.replicas)]
    server.drain()
    stats = server.stats()
    print(f"served {stats['replicas_done']} replicas "
          f"({stats['useful_steps']} useful steps) in "
          f"{stats['wall_s']:.3f}s -> {stats['replicas_per_s']:.2f} "
          f"replicas/s; {stats['compiles']} compiles over shapes "
          f"{stats['shapes_touched']}; step latency "
          f"p50={stats['step_latency_p50_ms']:.3f}ms "
          f"p99={stats['step_latency_p99_ms']:.3f}ms")
    if not all(h.status == "done" for h in handles):
        raise RuntimeError(f"replicas not done: "
                           f"{[h.status for h in handles]}")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--moe-dispatch", default="fused")
    ap.add_argument("--md", action="store_true",
                    help="serve MD replicas (SimServer) instead of LM waves")
    ap.add_argument("--replicas", type=int, default=8)
    ap.add_argument("--atoms", type=int, default=200)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--nstlist", type=int, default=10)
    ap.add_argument("--backend", default="dense",
                    choices=("dense", "sparse", "pallas"))
    args = ap.parse_args(argv)
    if args.md:
        return main_md(args)
    if args.arch is None:
        ap.error("--arch is required unless --md")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduce()
    refuse_encdec(cfg, "launch.serve")
    dev = resolve_device(args.device)
    model = build_model(cfg, device=dev,
                        moe_dispatch=args.moe_dispatch).init(
        torch.Generator(device=dev).manual_seed(0))
    server = BatchServer(model, batch_size=args.batch, max_len=args.max_len,
                         temperature=args.temperature)

    rng = np.random.RandomState(0)
    pending = [Request(prompt=rng.randint(0, cfg.vocab,
                                          size=(args.prompt_len,))
                       .astype(np.int32),
                       max_new_tokens=args.new_tokens)
               for _ in range(args.requests)]
    done = []
    wave = 0
    while pending:
        take, pending = pending[:args.batch], pending[args.batch:]
        out = server.serve_wave(take)
        stats = throughput_stats(out)
        print(f"wave {wave}: {len(take)} requests, "
              f"{stats['tokens']} tokens, {stats['tok_per_s']:.1f} tok/s")
        done.extend(out)
        wave += 1
    print(f"served {len(done)} requests on {dev}; sample output: "
          f"{done[0].out_tokens.tolist()}")
    return done


if __name__ == "__main__":
    main()
