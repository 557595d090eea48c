"""Runtime loops: the batched LM serving loop."""
