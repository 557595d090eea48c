"""Roofline arithmetic for one card: the port's copy of the arithmetic of
``src/repro/launch/hlo_analysis.py`` (``roofline_terms``,
``analytic_memory_bytes``).

The reference reads FLOPs, bytes and collective bytes from compiled XLA
HLO and divides them by a TPU's peaks.  The port compiles no HLO: its dry
run gives these functions the model's own FLOPs (``6 N tokens`` to train,
``2 N tokens`` to serve) and the analytic lower bound on the bytes a step
moves, and divides by the peaks of one NVIDIA H100 SXM (NVIDIA's data
sheet, dense, at the card's full 700 W power limit; the bounds of the
kernel table in ``PERF.md`` use the same two).  One card exchanges nothing
with another, so the collective term is zero.
"""
from __future__ import annotations

from typing import Dict

CARD = "NVIDIA H100 SXM, 80 GB (data sheet, 700 W)"
PEAK_FLOPS = 989e12          # bf16 on the tensor cores, dense
HBM_BW = 3.35e12             # device memory, bytes/s
HBM_BYTES = 80e9             # device memory


def roofline_terms(flops: float, bytes_moved: float) -> Dict:
    """The roofline terms in seconds of one step on one card: the model's
    ``flops`` over the bf16 peak, ``bytes_moved`` (the analytic lower
    bound) over the memory rate, a zero collective term, and the share of
    the bound the compute term is (the reference's ``roofline_fraction``).
    The reference's HLO-only terms (its parsed bytes beside the analytic
    ones, the useful share of the HLO's FLOPs) have no counterpart."""
    ct = flops / PEAK_FLOPS
    mt = bytes_moved / HBM_BW
    lt = 0.0
    dom = max((("compute", ct), ("memory", mt), ("collective", lt)),
              key=lambda kv: kv[1])[0]
    bound = max(ct, mt, lt)
    return {
        "compute_s": ct,
        "memory_s": mt,
        "collective_s": lt,
        "dominant": dom,
        "bound_s": bound,
        "roofline_fraction": ct / bound if bound else 0.0,
    }


def analytic_memory_bytes(n_params_stored: float, n_params_active: float,
                          tokens_local: float, d_model: int, n_layers: int,
                          kind: str, opt_bytes_per_param: float = 8.0,
                          cache_bytes_local: float = 0.0) -> float:
    """Per-device device-memory traffic lower bound for one step (the
    reference's).

    train: weights read (fwd+bwd) + grad write + optimizer state r/w +
    activations written+read once per layer boundary.  prefill/decode:
    weights once + cache traffic + activations.
    """
    act = tokens_local * d_model * 2.0 * n_layers
    if kind == "train":
        w = n_params_stored * (2 + 2 + 4)          # bf16 fwd+bwd, f32 grad w
        o = n_params_stored * opt_bytes_per_param * 2
        return w + o + act * 3.0 + cache_bytes_local
    w = n_params_active * 2.0
    return w + act * 2.0 + cache_bytes_local * 2.0
