"""Architecture registry of the port: the architectures it serves so far.

qwen1.5-0.5b is the slice's main path; gemma3-12b comes along for its
windowed (rotating) caches, gelu and embedding scale.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import LayerSpec, LinkConfig, ModelConfig
from repro_torch.configs.gemma3_12b import CONFIG as _gemma3
from repro_torch.configs.qwen1_5_0_5b import CONFIG as _qwen05

ARCHITECTURES: Dict[str, ModelConfig] = {c.name: c for c in [_qwen05, _gemma3]}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHITECTURES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHITECTURES)}")
    return ARCHITECTURES[name]


__all__ = ["ARCHITECTURES", "LayerSpec", "LinkConfig", "ModelConfig", "get_config"]
