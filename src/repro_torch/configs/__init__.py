"""Architecture registry: --arch <id> resolution for launchers and tests."""
from importlib import import_module

from .base import (RULES_FSDP_TP, RULES_TP, RULES_TP_2D,  # noqa: F401
                   RULES_ZERO3)
from .base import SHAPES, ModelConfig, MoEConfig, ShapeCell, cell_supported  # noqa: F401

_MODULES = {
    "recurrentgemma-9b": "recurrentgemma_9b",
    "rwkv6-7b": "rwkv6_7b",
    "internvl2-2b": "internvl2_2b",
    "stablelm-1.6b": "stablelm_1_6b",
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen1.5-32b": "qwen1_5_32b",
    "llama3.2-3b": "llama3_2_3b",
    "hubert-xlarge": "hubert_xlarge",
    "dbrx-132b": "dbrx_132b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
}

ARCHS = tuple(_MODULES)


def get(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {ARCHS}")
    return import_module(f"repro_torch.configs.{_MODULES[name]}").CONFIG
