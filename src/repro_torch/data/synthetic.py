"""Deterministic synthetic LM data pipeline (the port's own copy).

Properties a production loader must have, implemented here for the
synthetic stream:
  * deterministic as a function of (seed, step, host) — restart-safe,
  * per-host sharding (each host materializes only its batch slice),
  * checkpointable iterator state (a single step counter),
  * background prefetch with a bounded queue (double buffering).

Tokens follow a mixed unigram/copy process so cross-entropy training has
learnable structure (loss drops well below ln(vocab)).

A copy of ``src/repro/data/synthetic.py`` (plain numpy and a thread),
kept here because the port imports nothing of the reference package: the
same batches, bit for bit, for every (seed, step, host).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    copy_period: int = 7        # repeated motif => learnable structure
    n_hosts: int = 1
    host_id: int = 0


def _batch_at(cfg: DataConfig, step: int) -> np.ndarray:
    """Host's slice of the global batch for ``step`` (B_host, L+1).

    Every ROW is seeded by (seed, step, global_row), so the concatenation
    of all hosts' slices is identical to the single-host batch no matter
    how many hosts share the work (host-count elasticity).
    """
    assert cfg.global_batch % cfg.n_hosts == 0
    b_host = cfg.global_batch // cfg.n_hosts
    L = cfg.seq_len + 1
    reps = -(-L // cfg.copy_period)
    rows = []
    for r in range(cfg.host_id * b_host, (cfg.host_id + 1) * b_host):
        rng = np.random.Generator(np.random.PCG64(
            np.random.SeedSequence([cfg.seed, step, r])))
        motif = rng.integers(0, cfg.vocab, size=(cfg.copy_period,))
        seq = np.tile(motif, reps)[:L]
        noise = rng.integers(0, cfg.vocab, size=(L,))
        mask = rng.random(L) < 0.15
        rows.append(np.where(mask, noise, seq))
    return np.stack(rows).astype(np.int32)


class SyntheticStream:
    """Checkpointable iterator with optional background prefetch."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 prefetch: int = 2):
        self.cfg = cfg
        self.step = start_step
        self.prefetch = prefetch
        self._q: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        if prefetch > 0:
            self._start_worker()

    # ---- iterator state (checkpointable) -----------------------------------

    def state(self) -> Dict:
        return {"step": self.step}

    @classmethod
    def from_state(cls, cfg: DataConfig, state: Dict, prefetch: int = 2):
        return cls(cfg, start_step=int(state["step"]), prefetch=prefetch)

    # ---- iteration -----------------------------------------------------------

    def _start_worker(self):
        self._q = queue.Queue(maxsize=self.prefetch)
        self._next_to_produce = self.step

        def work():
            while not self._stop.is_set():
                s = self._next_to_produce
                batch = _batch_at(self.cfg, s)
                self._next_to_produce = s + 1
                while not self._stop.is_set():
                    try:
                        self._q.put((s, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._worker = threading.Thread(target=work, daemon=True)
        self._worker.start()

    def next(self) -> np.ndarray:
        if self._q is None:
            batch = _batch_at(self.cfg, self.step)
            self.step += 1
            return batch
        s, batch = self._q.get()
        # a restore may have rewound the step counter: regenerate if the
        # prefetched element is stale
        while s != self.step:
            if s < self.step:
                s, batch = self._q.get()
            else:
                batch = _batch_at(self.cfg, self.step)
                s = self.step
        self.step += 1
        return batch

    def close(self):
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=1.0)
