"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, Mamba:attention 7:1 interleave, MoE 16e top-2 on every other
layer.  [arXiv:2403.19887]

Unit of 8 layers (scanned 4x): mamba x4 / attn at index 4 / mamba x3,
MoE on odd in-unit indices (= every other layer globally).
"""

from repro_torch.configs.base import LayerSpec, LinkConfig, ModelConfig

_M = lambda moe: LayerSpec(kind="mamba", moe=moe)
_A = lambda moe: LayerSpec(kind="attn", moe=moe)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    source="arXiv:2403.19887",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    act="silu",
    gated_mlp=True,
    norm="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=False,
    unit_pattern=(
        _M(False), _M(True), _M(False), _M(True),
        _A(False), _M(True), _M(False), _M(True),
    ),
    num_experts=16,
    top_k=2,
    moe_dff=14336,
    capacity_factor=1.25,
    router_aux_coef=0.01,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    link=LinkConfig(split_after_units=1, dropout_rate=0.2, loss_rate=0.1,
                    compression="quant", quant_bits=8),
)
