"""Language models on one card (dense attention stacks)."""
from repro_torch.models.registry import build_model

__all__ = ["build_model"]
