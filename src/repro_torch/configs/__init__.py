"""Architecture registry of the port: ``--arch <id>`` resolves here.

Every arch of ``repro.configs`` is copied here; ``mellum2-12b`` is the
port's own (a :class:`LayerTypesConfig`: sliding and full attention
layers with their own RoPE, dropless experts), with no counterpart in
the reference.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (AttentionKind, BlockSpec,
                                      LayerTypesConfig, ModelConfig,
                                      MoEConfig, RopeSpec, reduced)
from repro_torch.configs.shapes import (SHAPES, SHAPES_BY_NAME, InputShape,
                                        get_shape, smoke_shape)

_ARCH_MODULES: Dict[str, str] = {
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
    "mellum2-12b": "repro_torch.configs.mellum2_12b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; options: "
                       f"{ARCH_IDS}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


__all__ = [
    "ARCH_IDS", "AttentionKind", "BlockSpec", "InputShape",
    "LayerTypesConfig", "ModelConfig", "MoEConfig", "RopeSpec", "SHAPES",
    "SHAPES_BY_NAME", "all_configs", "get_config", "get_shape", "reduced",
    "smoke_shape",
]
