"""Config registry: one module per assigned architecture + the MD workload."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ArchConfig

ARCH_IDS = (
    "internvl2_26b",
    "mistral_nemo_12b",
    "command_r_plus_104b",
    "qwen3_1_7b",
    "starcoder2_7b",
    "whisper_small",
    "olmoe_1b_7b",
    "llama4_maverick_400b_a17b",
    "rwkv6_3b",
    "jamba_v0_1_52b",
)

_ALIASES = {
    "internvl2-26b": "internvl2_26b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen3-1.7b": "qwen3_1_7b",
    "starcoder2-7b": "starcoder2_7b",
    "whisper-small": "whisper_small",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "rwkv6-3b": "rwkv6_3b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}


def get_config(arch: str) -> ArchConfig:
    mod_name = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
