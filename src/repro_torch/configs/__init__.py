"""Architecture registry of the port: the reference's ten LM configs.

qwen1.5-0.5b is the first slice's main path; gemma3-12b comes along for
its windowed (rotating) caches, gelu and embedding scale.  The attention
families of ROADMAP A12a follow: kimi-k2 (MoE with a shared expert, a
dense prologue, hd 112), arctic (MoE with a dense residual FFN),
qwen2-vl (M-RoPE, the vision frontend), musicgen (LayerNorm, a plain GELU
MLP, the audio frontend), codeqwen (untied head) and gemma-7b (hd 256).
The recurrent families of ROADMAP A12b close the set: jamba-v0.1 (Mamba
layers with attention every eighth layer, MoE on every other layer) and
xlstm-350m (mLSTM and sLSTM blocks).
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.arctic_480b import CONFIG as _arctic
from repro_torch.configs.base import LayerSpec, LinkConfig, ModelConfig
from repro_torch.configs.codeqwen1_5_7b import CONFIG as _codeqwen
from repro_torch.configs.gemma3_12b import CONFIG as _gemma3
from repro_torch.configs.gemma_7b import CONFIG as _gemma7b
from repro_torch.configs.jamba_v0_1_52b import CONFIG as _jamba
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as _kimi
from repro_torch.configs.musicgen_medium import CONFIG as _musicgen
from repro_torch.configs.qwen1_5_0_5b import CONFIG as _qwen05
from repro_torch.configs.qwen2_vl_72b import CONFIG as _qwen2vl
from repro_torch.configs.xlstm_350m import CONFIG as _xlstm

ARCHITECTURES: Dict[str, ModelConfig] = {
    c.name: c for c in [_jamba, _qwen05, _kimi, _arctic, _qwen2vl, _gemma3, _codeqwen, _musicgen, _gemma7b, _xlstm]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHITECTURES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHITECTURES)}")
    return ARCHITECTURES[name]


__all__ = ["ARCHITECTURES", "LayerSpec", "LinkConfig", "ModelConfig", "get_config"]
