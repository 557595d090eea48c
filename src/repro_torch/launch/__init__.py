"""Launch helpers: the virtual domain mesh and the serving launcher."""
