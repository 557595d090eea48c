from repro_torch.configs.base import (
    ArchConfig, LayerSpec, MoECfg, SHAPES, ShapeCfg, shape_applicable)
from repro_torch.configs.registry import ARCH_IDS, all_configs, get_config

__all__ = ["ArchConfig", "LayerSpec", "MoECfg", "SHAPES", "ShapeCfg",
           "shape_applicable", "ARCH_IDS", "all_configs", "get_config"]
