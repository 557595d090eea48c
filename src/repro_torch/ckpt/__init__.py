"""Fault-tolerant checkpoints (the reference's format, read by both)."""
from repro_torch.ckpt.checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
