"""End-to-end LM training driver on the card, on the synthetic pipeline.

``examples/train_lm.py`` through the PyTorch port: trains the reduced
qwen3 config (--full-100m: the reference's ~100M-parameter variant,
qwen3-100m, 8 layers of d 768) with checkpoints every 40 steps into a
temporary directory, resume and the straggler watchdog; on the card every
step runs the flash-attention kernel and its backward.

  PYTHONPATH=src python examples/torch/train_lm.py [--full-100m]
  PYTHONPATH=src python examples/torch/train_lm.py --device cpu
"""
import argparse
import dataclasses
import tempfile

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.data.synthetic import DataConfig
from repro_torch.launch.steps import make_ctx, make_train_step
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import TrainLoopConfig, run_training


def main(full=False, total_steps=None, device="cuda"):
    cfg = get_config("qwen3-1.7b")
    if full:
        cfg = dataclasses.replace(cfg, n_layers=8, d_model=768, n_heads=8,
                                  n_kv_heads=4, head_dim=96, d_ff=2048,
                                  vocab=32000, remat=False,
                                  compute_dtype="float32",
                                  name="qwen3-100m")
    else:
        cfg = cfg.reduce()
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64,
                                global_batch=8)
    ctx = make_ctx(cfg, shape, device=device, fsdp=False)
    prog = make_train_step(cfg, shape,
                           ocfg=adamw.AdamWConfig(lr=5e-3, warmup_steps=10,
                                                  total_steps=300),
                           microbatches=1, device=ctx.device)
    data = DataConfig(vocab=min(cfg.vocab, 512), seq_len=64,
                      global_batch=8, seed=0, copy_period=2)
    if total_steps is None:
        total_steps = 300 if full else 120
    gen = torch.Generator(device=ctx.device).manual_seed(0)
    with tempfile.TemporaryDirectory() as d:
        loop = TrainLoopConfig(total_steps=total_steps, ckpt_dir=d,
                               ckpt_every=40, log_every=10)
        model = prog.model
        params, opt, hist = run_training(loop, prog, data,
                                         lambda: model.init(gen))
    print(f"loss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    return hist


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(full=a.full_100m, device=a.device)
