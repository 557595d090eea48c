"""End-to-end serving driver on the card: batched requests against a small
model.

``examples/serve_batch.py`` through the PyTorch port: the reduced
qwen3-1.7b config, 8 requests served in waves of 4 by ``BatchServer``
(prefill through the flash-attention kernel on the card, then greedy
decode), the throughput printed with the card's name and power limit.

  PYTHONPATH=src python examples/torch/serve_batch.py
  PYTHONPATH=src python examples/torch/serve_batch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch import BatchServer, build_model, get_config
from repro_torch.device import card_label, resolve_device
from repro_torch.runtime.serve_loop import Request, throughput_stats


def main(n_requests=8, batch_size=4, max_new_tokens=12, device="cuda"):
    dev = resolve_device(device)
    cfg = get_config("qwen3-1.7b").reduce()
    model = build_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    server = BatchServer(model, batch_size=batch_size, max_len=64)

    rng = np.random.RandomState(0)
    reqs = [Request(prompt=rng.randint(0, cfg.vocab, size=(10,))
                    .astype(np.int32), max_new_tokens=max_new_tokens)
            for _ in range(n_requests)]
    done = []
    while reqs:
        wave, reqs = reqs[:batch_size], reqs[batch_size:]
        done += server.serve_wave(wave)
        print(throughput_stats(done), "on", card_label(dev))
    print("sample continuation:", done[0].out_tokens.tolist())
    return done


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
