"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384e top-8 (+1 shared expert), first layer dense.
Trillion-param MoE (paper-table config).  [arXiv:2501.kimi2]"""

from repro_torch.configs.base import LayerSpec, LinkConfig, ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    source="arXiv:2501.kimi2",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,            # per-expert width (dense first layer uses the same)
    vocab_size=163840,
    act="silu",
    gated_mlp=True,
    norm="rmsnorm",
    rope_theta=50000.0,
    tie_embeddings=False,
    prologue=(LayerSpec(kind="attn", moe=False),),   # first layer dense
    unit_pattern=(LayerSpec(kind="attn", moe=True),),
    num_experts=384,
    top_k=8,
    moe_dff=2048,
    num_shared_experts=1,
    capacity_factor=1.25,
    router_aux_coef=0.01,
    link=LinkConfig(split_after_units=7, dropout_rate=0.2, loss_rate=0.1,
                    compression="quant", quant_bits=8),
)
