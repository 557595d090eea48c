"""Optimizers of the port (AdamW)."""
