"""Batched serving loop: prefill + lockstep decode with a request queue.

Port of ``src/repro/runtime/serve_loop.py``.  Requests are admitted in
waves; each wave is left-padded with token 0 to its longest prompt,
prefilled into a fresh KV cache (prefill attends over the pads, positions
from 0, as the reference does) and decoded in lockstep, one
``decode_step`` per token across the whole batch.  Per-request budgets
trim each row's output.  Greedy sampling is ``argmax`` (the first index on
ties, as ``jnp.argmax``); temperature sampling draws from a
``torch.Generator`` seeded by ``seed`` (its numbers are not JAX's).  A
per-wave deadline (``wave_timeout_s``), checked after
``torch.cuda.synchronize()`` so it sees device work rather than dispatch,
turns a decode loop that runs over into a typed :class:`WaveTimeout`, and
an optional :class:`Watchdog` watches per-wave wall time for stragglers.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.resilience.faults import WaveTimeout
from repro_torch.resilience.policy import Watchdog


@dataclasses.dataclass
class Request:
    prompt: np.ndarray            # (L,) int32
    max_new_tokens: int
    out_tokens: Optional[np.ndarray] = None
    latency_s: float = 0.0
    wave: int = -1                # which wave served it (-1 = not served)


def masked_tokens(decoded, budgets) -> int:
    """Useful work across padded rows: ``sum(min(decoded_i, budget_i))``.

    Batched programs run every row to the padded maximum; only the
    requested budget is useful, so throughput counts must mask the
    padding out.
    """
    return int(sum(max(0, min(int(d), int(b)))
                   for d, b in zip(decoded, budgets)))


def refuse_encdec(cfg, what: str) -> None:
    """Raise ``NotImplementedError`` for an encoder-decoder ``cfg``: the
    serving and training loops feed tokens only, as the reference's do."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{what} feeds tokens only, and {cfg.name} also needs frames: "
            "drive an encoder-decoder through launch.steps' "
            "make_train_step, make_prefill_step and make_decode_step")


class BatchServer:
    """Serves waves of up to ``batch_size`` requests on ``model``'s device
    through its ``prefill`` / ``decode_step`` entry points (token models:
    an encoder-decoder raises ``NotImplementedError``)."""

    def __init__(self, model, batch_size: int, max_len: int,
                 temperature: float = 0.0, seed: int = 0,
                 wave_timeout_s: Optional[float] = None,
                 watchdog: Optional[Watchdog] = None):
        refuse_encdec(model.cfg, "BatchServer")
        self.model = model
        self.B = batch_size
        self.max_len = max_len
        self.temperature = temperature
        self.wave_timeout_s = wave_timeout_s
        self.watchdog = watchdog
        self._waves = 0
        self.rng = torch.Generator(device=model.device).manual_seed(seed)

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def serve_wave(self, requests: List[Request]) -> List[Request]:
        """Serve up to B same-length-padded requests as one wave.

        Raises :class:`WaveTimeout` when the wave's decode loop exceeds
        ``wave_timeout_s``."""
        if not 0 < len(requests) <= self.B:
            raise ValueError(f"a wave takes 1..{self.B} requests, got "
                             f"{len(requests)}")
        t0 = time.perf_counter()
        B = self.B
        plen = max(r.prompt.shape[0] for r in requests)
        new_tokens = max(r.max_new_tokens for r in requests)
        if plen + new_tokens > self.max_len:
            raise ValueError(f"prompt {plen} + {new_tokens} new tokens "
                             f"exceed max_len {self.max_len}")
        toks = np.zeros((B, plen), np.int32)
        for i, r in enumerate(requests):
            toks[i, plen - r.prompt.shape[0]:] = r.prompt   # left-pad
        dev = self.model.device
        cache = self.model.init_cache(B, self.max_len)
        logits, cache = self.model.prefill(
            {"tokens": torch.from_numpy(toks).to(dev)}, cache)
        outs = np.zeros((B, new_tokens), np.int32)
        pos = plen - 1
        tok = self._sample(logits)
        for t in range(new_tokens):
            outs[:, t] = tok[:, 0].cpu().numpy()
            pos += 1
            logits, cache = self.model.decode_step(tok, pos, cache)
            tok = self._sample(logits)
            if self.wave_timeout_s is not None:
                self._sync()
                elapsed = time.perf_counter() - t0
                if elapsed > self.wave_timeout_s:
                    raise WaveTimeout(
                        f"wave exceeded {self.wave_timeout_s:.3f}s after "
                        f"{t + 1}/{new_tokens} decode steps "
                        f"({elapsed:.3f}s elapsed)")
        # the last sampled token is still in flight: sync so dt covers
        # the whole wave
        self._sync()
        dt = time.perf_counter() - t0
        if self.watchdog is not None:
            self.watchdog.observe(self._waves, dt)
        for i, r in enumerate(requests):
            r.out_tokens = outs[i, : r.max_new_tokens]
            r.latency_s = dt
            r.wave = self._waves
        self._waves += 1
        return requests

    def _sample(self, logits):
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.rng) \
            .to(torch.int32)


def throughput_stats(requests: List[Request]) -> Dict[str, float]:
    """Token throughput over any mix of served requests.

    Tokens are budget-masked (:func:`masked_tokens`); wall time is the
    sum over distinct waves of each wave's latency (requests of one wave
    share it).
    """
    served = [r for r in requests if r.out_tokens is not None]
    tokens = masked_tokens((r.out_tokens.shape[0] for r in served),
                           (r.max_new_tokens for r in served))
    per_wave: Dict[int, float] = {}
    for r in served:
        per_wave[r.wave] = max(per_wave.get(r.wave, 0.0), r.latency_s)
    wall = sum(per_wave.values())
    return {"tokens": tokens, "wall_s": wall,
            "tok_per_s": tokens / max(wall, 1e-9)}
