"""Launch helpers: the virtual domain mesh."""
