"""Serving launcher: batched LM waves on one card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --reduced --requests 16 --batch 4 --new-tokens 16 [--device cpu]

Runs on the card unless ``--device cpu`` is given (and raises without
CUDA).  Weights are random, drawn from a ``torch.Generator`` seeded
with 0; prompts from ``numpy.random.RandomState(0)``.  ``--md``
(continuous batching of MD replicas through ``SimServer``) is not ported
yet (ROADMAP A12).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.runtime.serve_loop import BatchServer, Request, \
    throughput_stats


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
    ap.add_argument("--md", action="store_true",
                    help="serve MD replicas (SimServer): not ported yet")
    args = ap.parse_args(argv)
    if args.md:
        raise NotImplementedError("--md serves MD replicas through "
                                  "SimServer, not ported yet (ROADMAP A12)")
    if args.arch is None:
        ap.error("--arch is required")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduce()
    dev = resolve_device(args.device)
    model = build_model(cfg, device=dev).init(
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
