"""Model registry: config -> model (the ``LM``: dense or MoE)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import LM


def build_model(cfg: ArchConfig, device="cuda",
                moe_dispatch: str = "fused", expert_share=None) -> LM:
    """The model for ``cfg`` with uninitialised parameters on ``device``
    (call ``.init(generator)`` or ``.load_state_dict``); MoE layers
    dispatch by ``moe_dispatch`` (``models.moe.DISPATCHES``) and hold
    ``expert_share`` (``(index, count)``: one card's experts of
    ``count``-way expert parallelism; None, all).  Raises on a config the
    port cannot build yet, and on CUDA when it is absent."""
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are "
                                  "not ported yet (ROADMAP A14: enc-dec)")
    return LM(cfg, device=device, moe_dispatch=moe_dispatch,
              expert_share=expert_share)
