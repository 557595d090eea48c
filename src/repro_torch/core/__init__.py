"""Core: the staged halo exchange and the MD substrate, on a virtual mesh."""
