"""Architecture registry: --arch <id> resolution for launchers and tests."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b_a17b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, *, smoke: bool = False, **overrides) -> ArchConfig:
    mod = importlib.import_module(_MODULES[arch_id])
    cfg = mod.SMOKE if smoke else mod.CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def train_schedule(arch_id: str) -> str:
    mod = importlib.import_module(_MODULES[arch_id])
    return getattr(mod, "TRAIN_SCHEDULE", "cosine")
