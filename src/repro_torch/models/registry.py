"""Model registry: config -> model (the ``LM``: dense, MoE, state-space;
the ``EncDec``: encoder-decoder) and its parameter declaration."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.encdec import EncDec, encdec_defs
from repro_torch.models.layers import ParamDefs
from repro_torch.models.transformer import LM


def _refuse_share(cfg: ArchConfig, expert_share) -> None:
    if expert_share is not None:
        raise ValueError(f"{cfg.name}: an expert share needs MoE layers, "
                         "and an encoder-decoder model has none")


def build_model(cfg: ArchConfig, device="cuda",
                moe_dispatch: str = "fused", expert_share=None):
    """The model for ``cfg`` with uninitialised parameters on ``device``
    (call ``.init(generator)`` or ``.load_state_dict``): an ``EncDec``
    for an encoder-decoder config, else an ``LM`` whose MoE layers
    dispatch by ``moe_dispatch`` (``models.moe.DISPATCHES``) and hold
    ``expert_share`` (``(index, count)``: one card's experts of
    ``count``-way expert parallelism; None, all).  Raises on a config the
    port cannot build yet, and on CUDA when it is absent."""
    if cfg.is_encdec:
        _refuse_share(cfg, expert_share)
        return EncDec(cfg, device=device)
    return LM(cfg, device=device, moe_dispatch=moe_dispatch,
              expert_share=expert_share)


def model_defs(cfg: ArchConfig, expert_share=None) -> ParamDefs:
    """The reference's stacked declaration of every parameter of ``cfg``'s
    model (MoE layers holding ``expert_share``'s experts)."""
    if cfg.is_encdec:
        _refuse_share(cfg, expert_share)
        return encdec_defs(cfg)
    return transformer.model_defs(cfg, expert_share)
